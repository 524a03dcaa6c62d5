"""The device track preparation (stage `dev_prep`: CUDA events around the
eager float64 preparation and prefix.cu, gaps between launches included),
ms per preparation (`device_prep` counts every piece and cut-point exam
prepared on the device route)."""


def read(r):
    t, k = r.times.get("dev_prep"), r.counts.get("device_prep", 0)
    return None if t is None or not k else t * 1e3 / k
