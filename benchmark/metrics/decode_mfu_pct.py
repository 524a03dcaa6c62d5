"""The whole decode's share of the H100's float32 peak: the operations of
the decoded records' recursion (benchlib.work) over the traced window's
seconds times 67 TFLOP/s."""

from benchlib.peaks import H100_FP32_FLOPS


def read(r):
    if not r.work_ops or not r.window_s:
        return None
    return 100.0 * r.work_ops / (r.window_s * H100_FP32_FLOPS)
