"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

`csrc/<name>.cu` is compiled at first use, from the sources in the
checkout, into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash covers the source, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header rebuilds).  A variant of a source,
built with preprocessor defines (`load("forward", ("K3_SPLIT",))`), is a
library of its own; the main path loads none.
Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC"]

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


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


def _flags(defines) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines=()) -> str:
    h = hashlib.sha1(" ".join(_flags(defines)).encode())
    # the source and every shared header in csrc/
    for src in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as fh:
            h.update(fh.read())
    tag = "".join("-" + d.lower() for d in defines)
    return os.path.join(BUILD_DIR, f"lib{name}{tag}-{h.hexdigest()[:12]}.so")


def _nvcc_cmd(name: str, out: str, defines=()):
    return [find_nvcc()] + _flags(defines) + [
        "-o", out, os.path.join(CSRC, name + ".cu")]


def _spec(spec) -> Tuple[str, Tuple[str, ...]]:
    return (spec, ()) if isinstance(spec, str) else (spec[0], tuple(spec[1]))


def build_all(specs) -> None:
    """Build the shared libraries of several kernels at once, one nvcc per
    source, all started together (a failed build raises).  A spec is a
    source name or (name, defines)."""
    todo = [(nm, d, _lib_path(nm, d)) for nm, d in map(_spec, specs)]
    todo = [t for t in todo if not os.path.exists(t[2])]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for nm, d, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        procs.append((nm, d, path, tmp,
                      subprocess.Popen(_nvcc_cmd(nm, tmp, d))))
    failed = []
    for nm, d, path, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(" ".join([f"csrc/{nm}.cu"] + [f"-D{x}" for x in d]))
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu built with `defines`,
    building it if needed (nvcc's messages go to stderr; a failed build
    raises)."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        path = _lib_path(*key)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(_nvcc_cmd(name, tmp, key[1]), check=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        _loaded[key] = lib
    return lib
