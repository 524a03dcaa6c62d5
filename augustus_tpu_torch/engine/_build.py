"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

`csrc/<name>.cu` is compiled at first use, from the sources in the
checkout, into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash covers the source and the flags, so an edited source rebuilds).
Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return p


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        h = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, building it if needed
    (nvcc's messages go to stderr; a failed build raises)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run([find_nvcc()] + NVCC_FLAGS +
                           ["-o", tmp, os.path.join(CSRC, name + ".cu")],
                           check=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
