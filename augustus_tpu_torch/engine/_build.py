"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

`csrc/<name>.cu` is compiled at first use, from the sources in the
checkout, into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash covers the source, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header rebuilds).
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
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC"]

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
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header in csrc/
    for src in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _nvcc_cmd(name: str, out: str):
    return [find_nvcc()] + NVCC_FLAGS + ["-o", out,
                                         os.path.join(CSRC, name + ".cu")]


def build_all(names) -> None:
    """Build the shared libraries of several kernels at once, one nvcc per
    source, all started together (a failed build raises)."""
    todo = [(nm, _lib_path(nm)) for nm in names
            if not os.path.exists(_lib_path(nm))]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for nm, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        procs.append((nm, path, tmp,
                      subprocess.Popen(_nvcc_cmd(nm, tmp))))
    failed = []
    for nm, path, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(nm)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"csrc/{nm}.cu" for nm in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, building it if needed
    (nvcc's messages go to stderr; a failed build raises)."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(_nvcc_cmd(name, tmp), check=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
