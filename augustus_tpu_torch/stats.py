"""Stage timers for the prediction pipeline.

Port of `augustus_tpu/stats.py`: a per-stage breakdown (prep / dev_prep /
track build / pack / expand / kernel / forward / traceback / sample / gene
projection / MEA / printing), enabled by `reset(True)`; `predict` and the engine call
`stage(name)` unconditionally (a no-op when disabled).  `stage(name,
device)` on a CUDA device times the enclosed work with CUDA events and
synchronizes at its end, so the number is device time (`forward`: the
forward table's plane expansion and kernel); elsewhere it is host wall time
(`sample`: the host sampling walk and the projection of the sampled
paths; `mea`: the MEA graph and its longest path, output/mea.py).  `count(name)` counts events: the route of every piece
(`device_prep` or `host_prep`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

_ENABLED = False
TIMES: Dict[str, float] = {}
COUNTS: Dict[str, int] = {}


def reset(enabled: bool = True) -> None:
    global _ENABLED
    _ENABLED = enabled
    TIMES.clear()
    COUNTS.clear()


def count(name: str, k: int = 1) -> None:
    if _ENABLED:
        COUNTS[name] = COUNTS.get(name, 0) + k


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
    counts = " ".join(f"{k}={v}" for k, v in sorted(COUNTS.items()))
    return f"stages({total:.2f}s tracked): " + " ".join(parts) + \
        (f" counts: {counts}" if counts else "")
