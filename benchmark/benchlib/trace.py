"""The traced run: the program's stage spans and counters, and the device
trace of `torch.profiler` over the window.

`augustus_tpu_torch.stats` times each stage of a record (CUDA events on
the card, the host clock elsewhere) and counts each piece's route once
`stats.reset(True)` turns it on; every stage then synchronizes, which is
why no end-to-end metric is read in a traced run.  Each stage is also
entered as a `record_function` span, so that the device trace can tell
which stage the host was in during each idle gap of the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

STAGE_PREFIX = "stage:"


class StageSpans:
    """Wraps the program's `stats.stage` so that each stage is also a
    profiler span named `stage:<name>`; `restore()` puts it back."""

    def __init__(self, stats_module):
        import torch
        self.stats = stats_module
        self.plain = stats_module.stage
        plain = self.plain

        @contextlib.contextmanager
        def stage(name, device=None):
            with torch.profiler.record_function(STAGE_PREFIX + name):
                with plain(name, device):
                    yield
        stats_module.stage = stage

    def restore(self) -> None:
        self.stats.stage = self.plain


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def read_profile(prof, window_s: float) -> Optional[dict]:
    """busy_s, the top device ops and the idle gaps by host stage, from a
    finished profiler; None when the trace holds no device activity.
    Reads the profiler's raw events (no event tree is built)."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = ev.start_ns() / 1e9, (ev.start_ns() + ev.duration_ns()) / 1e9
        if ev.device_type() == DeviceType.CUDA:
            if not (ev.is_user_annotation() or name.startswith(STAGE_PREFIX)):
                dev.append((name, s, e))
        elif name.startswith(STAGE_PREFIX):
            spans.append((name[len(STAGE_PREFIX):], s, e))
    if not dev:
        return None
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = {}
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    # each idle gap between device activity, named by the innermost stage
    # that the host was in at its midpoint
    # (stages nest, so the innermost is the latest begun of those open)
    idle: Dict[str, float] = {}
    spans.sort(key=lambda x: x[1])
    active: list = []
    k = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        while k < len(spans) and spans[k][1] <= mid:
            active.append(spans[k])
            k += 1
        active = [sp for sp in active if sp[2] >= mid]
        name = active[-1][0] if active else "between stages"
        idle[name] = idle.get(name, 0.0) + (s1 - e0)
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": top(by_op), "idle_gaps": top(idle)}
