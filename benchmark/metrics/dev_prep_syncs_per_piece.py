"""Operations of the device track preparation that block the host until
the card's stream drains (counter `dev_prep_syncs`: blocking copies
between host and card, values read back, outputs sized by the data), per
counted preparation (`dev_prep_counted`)."""


def read(r):
    n, k = r.counts.get("dev_prep_syncs"), r.counts.get("dev_prep_counted", 0)
    return None if n is None or not k else n / k
