"""augustus_tpu_torch: the AUGUSTUS gene finder of augustus_tpu, ported to
PyTorch and hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package `augustus_tpu` is the reference; this package imports
neither it nor JAX.  Entry points run on `cuda` unless the caller passes
`device="cpu"`, where each kernel's plain PyTorch version runs instead.
CUDA kernels are built from `csrc/` at first use, never on import.
"""

__version__ = "0.1.0"
