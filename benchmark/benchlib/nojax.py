"""The check that no module of JAX or of the JAX package is loaded."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "augustus_tpu")


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among the modules (sys.modules by
    default), each compared whole: `augustus_tpu_torch` is not
    `augustus_tpu`."""
    names = {m.split(".")[0] for m in
             (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)
