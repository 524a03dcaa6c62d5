"""The device track preparation on the host clock (stage `dev_prep`'s
`host:dev_prep`: the eager launches, copies and syncs that the host issues,
the waits for the card included), ms per preparation (`device_prep` counts
every piece and cut-point exam prepared on the device route)."""


def read(r):
    t, k = r.times.get("host:dev_prep"), r.counts.get("device_prep", 0)
    return None if t is None or not k else t * 1e3 / k
