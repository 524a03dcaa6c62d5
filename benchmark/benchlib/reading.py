"""What a traced run hands to each per-layer metric's reader."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Reading:
    times: Dict[str, float]          # augustus_tpu_torch.stats.TIMES (s)
    counts: Dict[str, int]           # augustus_tpu_torch.stats.COUNTS
    bases: int                       # bases of the records decoded
    window_s: float                  # the traced window (host clock)
    peak_bytes: int                  # max_memory_allocated in the window
    work_ops: int                    # benchlib.work: the decode's operations
    work_bytes: int                  # benchlib.work: the decode's bytes
    pieces: List[dict] = field(default_factory=list)  # decode_pieces.last
    profile: Optional[dict] = None   # benchlib.trace.read_profile

    @property
    def mb(self) -> float:
        return self.bases / 1e6
