"""ATen operations of the device track preparation that are not views,
plus prefix.cu's launches and the copies of Python data that torch makes
below the dispatcher (counter `dev_prep_ops`), per counted preparation
(`dev_prep_counted`: the program counts the first preparation of the
traced window)."""


def read(r):
    n, k = r.counts.get("dev_prep_ops"), r.counts.get("dev_prep_counted", 0)
    return None if n is None or not k else n / k
