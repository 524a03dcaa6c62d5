"""Stage timers for the prediction pipeline.

Port of `augustus_tpu/stats.py`: a per-stage breakdown (prep / track build /
pack / expand / kernel / traceback / gene projection / printing), enabled by
`reset(True)`; `predict` and the engine call `stage(name)` unconditionally
(a no-op when disabled).  `stage(name, device)` on a CUDA device times the
enclosed work with CUDA events and synchronizes at its end, so the number
is device time; elsewhere it is host wall time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

_ENABLED = False
TIMES: Dict[str, float] = {}


def reset(enabled: bool = True) -> None:
    global _ENABLED
    _ENABLED = enabled
    TIMES.clear()


def add(name: str, seconds: float) -> None:
    if _ENABLED:
        TIMES[name] = TIMES.get(name, 0.0) + seconds


@contextmanager
def stage(name: str, device=None):
    if not _ENABLED:
        yield
        return
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            add(name, start.elapsed_time(end) / 1000.0)
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def report() -> str:
    total = sum(TIMES.values())
    parts = [f"{k}={v:.2f}s" for k, v in
             sorted(TIMES.items(), key=lambda kv: -kv[1])]
    return f"stages({total:.2f}s tracked): " + " ".join(parts)
