"""Bytes that the device track preparation copies from the host to the
card (counter `dev_prep_h2d_bytes`: model tables, letters, GC stairs,
overlays, scalars), MB per counted preparation (`dev_prep_counted`)."""


def read(r):
    n = r.counts.get("dev_prep_h2d_bytes")
    k = r.counts.get("dev_prep_counted", 0)
    return None if n is None or not k else n / 1e6 / k
