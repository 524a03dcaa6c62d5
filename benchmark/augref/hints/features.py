"""Hint features and groups (reference include/hints.hh Feature/HintGroup).

Minimal representation sufficient for the DP bonus tracks and the evidence
reporting; the GFF hint reader populates the same structures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Feature:
    start: int
    end: int
    type: str                  # one of hints.config.FEATURE_TYPES
    strand: str = "."          # '+', '-', '.' (both/unknown)
    score: float = 0.0
    source: str = "M"          # source key (esource)
    bonus: float = 1.0
    malus: float = 1.0
    groupname: str = ""
    priority: int = -1
    mult: int = 1


@dataclass
class HintGroup:
    hints: List[Feature] = field(default_factory=list)
    name: str = ""

    @property
    def begin(self) -> int:
        return min(h.start for h in self.hints)

    @property
    def end(self) -> int:
        return max(h.end for h in self.hints)

    @property
    def source(self) -> str:
        return self.hints[0].source if self.hints else ""

    @property
    def gene_begin(self) -> int:
        """Begin over genic hints only (reference hints.cc:594: irpart and
        nonexonpart hints don't count); -1 if none."""
        starts = [h.start for h in self.hints
                  if h.type not in ("irpart", "nonexonpart")]
        return min(starts) if starts else -1

    @property
    def gene_end(self) -> int:
        ends = [h.end for h in self.hints
                if h.type not in ("irpart", "nonexonpart")]
        return max(ends) if ends else -1


def group_gaps(groups: List[HintGroup], seqlen: int) -> List[tuple]:
    """Gaps between hint groups (reference
    SequenceFeatureCollection::findGroupGaps, extrinsicinfo.cc:1026):
    start with the full interval [1, seqlen] and chop out each group's
    genic interval, walking a single gap cursor in group-begin order."""
    gaps = [[1, seqlen]]
    cursor = 0
    for grp in sorted(groups, key=lambda g: g.begin):
        gb, ge = grp.gene_begin, grp.gene_end
        if gb < 0 or gb > seqlen:
            continue
        if cursor >= len(gaps):
            break
        cur = gaps[cursor]
        if gb > cur[0] and ge < cur[1]:
            gaps.insert(cursor, [cur[0], gb - 1])
            cursor += 1
            cur[0] = ge + 1
        elif cur[0] >= gb and ge >= cur[0] and ge < cur[1]:
            cur[0] = ge + 1
        elif gb <= cur[0] and ge >= cur[1]:
            del gaps[cursor]
            break
        elif gb > cur[0] and gb <= cur[1] and ge >= cur[1]:
            cur[1] = gb - 1
            break
    return [(a, b) for a, b in gaps]


def softmask_hints(softmask: np.ndarray, ext_cfg) -> List[HintGroup]:
    """Lowercase runs -> nonexonpart 'RM' hints, one group each
    (reference SequenceFeatureCollection::prepare, extrinsicinfo.cc:1697)."""
    groups: List[HintGroup] = []
    n = softmask.shape[0]
    pos = 0
    bonus = ext_cfg.bonus_for("nonexonpart", "RM", 0.0) if ext_cfg else 1.0
    if bonus == 1.0:
        return groups   # reference drops bonus-1 hints (extrinsicinfo.cc:1718)
    mask = np.asarray(softmask, dtype=bool)
    while pos < n:
        while pos < n and not mask[pos]:
            pos += 1
        if pos < n:
            start = pos
            end = pos
            while end + 1 < n and mask[end + 1]:
                end += 1
            f = Feature(start=start, end=end, type="nonexonpart",
                        strand=".", score=0.0, source="RM", bonus=bonus,
                        priority=-1, mult=1)
            groups.append(HintGroup(hints=[f], name=""))
            pos = end + 1
    return groups
