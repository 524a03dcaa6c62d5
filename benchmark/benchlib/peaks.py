"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), as chip_smoke.py states them."""

H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12   # HBM3


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES_PER_S)
