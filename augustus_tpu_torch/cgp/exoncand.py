"""Exon candidate generation for CGP.

Reference: src/exoncand.cc (createExonCands, geneMSA.cc:189): for each
species sequence of a gene range, enumerate candidate exons of the core
types from signal positions — start/stop codons and splice sites — with
per-type frame and length constraints.  Reference keys candidates into an
int64 (type, end, length); here a flat record list with a tuple key.

Signal tracks (stop codons, ATG, gt/ag dinucleotides) are vectorized
boolean masks; in-frame-stop barriers use per-frame suffix minima (the
reference's OpenReadingFrame idea, include/exonmodel.hh:32-49).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .. import genetics

# candidate exon types (subset of reference ExonType, exoncand.hh)
SINGLE, INITIAL, INTERNAL, TERMINAL = 0, 1, 2, 3
TYPE_NAMES = {SINGLE: "single", INITIAL: "initial", INTERNAL: "internal",
              TERMINAL: "terminal"}


@dataclass(frozen=True)
class ExonCandidate:
    begin: int          # 0-based inclusive, forward-strand coordinates
    end: int
    etype: int
    strand: str         # '+' or '-'
    frame: int          # phase of the first base (0 = codon-aligned)
    score: float = 0.0

    def key(self):
        return (self.begin, self.end, self.etype, self.strand, self.frame)


def _stop_mask(codes: np.ndarray) -> np.ndarray:
    """True where a stop codon (taa/tag/tga) starts (forward)."""
    n = codes.shape[0]
    m = np.zeros(n, dtype=bool)
    if n < 3:
        return m
    c0, c1, c2 = codes[:-2], codes[1:-1], codes[2:]
    t, a, g = 3, 0, 2
    m[: n - 2] = ((c0 == t) & (c1 == a) & (c2 == a)) | \
                 ((c0 == t) & (c1 == a) & (c2 == g)) | \
                 ((c0 == t) & (c1 == g) & (c2 == a))
    return m


def _codon2_mask(codes: np.ndarray, b0: int, b1: int, b2: int) -> np.ndarray:
    n = codes.shape[0]
    m = np.zeros(n, dtype=bool)
    if n >= 3:
        m[: n - 2] = (codes[:-2] == b0) & (codes[1:-1] == b1) & \
            (codes[2:] == b2)
    return m


def _dinuc_mask(codes: np.ndarray, b0: int, b1: int) -> np.ndarray:
    n = codes.shape[0]
    m = np.zeros(n, dtype=bool)
    if n >= 2:
        m[: n - 1] = (codes[:-1] == b0) & (codes[1:] == b1)
    return m


class _StopBarrier:
    """next in-frame stop queries via per-frame suffix minima."""

    def __init__(self, stops: np.ndarray, n: int):
        self.n = n
        stop_pos = np.where(stops, np.arange(n), 2 * n)
        self.sufmin = []
        for f in range(3):
            sp = stop_pos[f::3]
            self.sufmin.append(
                np.minimum.accumulate(sp[::-1])[::-1] if sp.size
                else np.empty(0, dtype=np.int64))

    def next_from(self, b: int, frame: int) -> int:
        """first stop start s >= b in the reading frame of an exon whose
        first base has phase `frame` (codon boundary at b + (3-frame)%3)."""
        i = b + (3 - frame) % 3
        if i >= self.n:
            return 2 * self.n
        fr = i % 3
        k = (i - fr) // 3
        sp = self.sufmin[fr]
        return int(sp[k]) if k < sp.shape[0] else 2 * self.n


def generate_exon_candidates(seq: str, max_exon_len: int = 12000,
                             min_exon_len: int = 15,
                             donors_per_site: int = 6
                             ) -> List[ExonCandidate]:
    """Candidate exons on both strands (reference
    GeneMSA::createExonCands, geneMSA.cc:189; exoncand.cc:140+).

    Coordinates are forward-strand 0-based [begin, end] of the biological
    exon; minus-strand candidates are generated on the reverse complement
    and mapped back.
    """
    out: List[ExonCandidate] = []
    codes_f = genetics.encode(seq.lower())
    n = codes_f.shape[0]
    for strand in ("+", "-"):
        codes = codes_f if strand == "+" else \
            genetics.reverse_complement(codes_f)
        barrier = _StopBarrier(_stop_mask(codes), n)
        atg_pos = np.flatnonzero(_codon2_mask(codes, 0, 3, 2))
        don_pos = np.flatnonzero(_dinuc_mask(codes, 2, 3))  # gt: intron start
        acc_pos = np.flatnonzero(_dinuc_mask(codes, 0, 2))  # ag: intron end

        def emit(b, e, etype, frame):
            if e - b + 1 < min_exon_len or e - b + 1 > max_exon_len \
                    or e >= n or b < 0:
                return
            if strand == "+":
                out.append(ExonCandidate(b, e, etype, "+", frame))
            else:
                out.append(ExonCandidate(n - 1 - e, n - 1 - b, etype, "-",
                                         frame))

        # SINGLE + INITIAL from each ATG
        for b in atg_pos.tolist():
            ns = barrier.next_from(b, 0)
            if ns < 2 * n:
                emit(b, ns + 2, SINGLE, 0)
            lo = np.searchsorted(don_pos, b + 3)
            hi = np.searchsorted(don_pos, min(ns + 3 if ns < 2 * n else n,
                                              b + max_exon_len))
            for d in don_pos[lo:hi][:donors_per_site].tolist():
                emit(b, d - 1, INITIAL, 0)

        # INTERNAL + TERMINAL from each acceptor (exon begins after "ag")
        for a in acc_pos.tolist():
            b = a + 2
            if b >= n:
                continue
            for f in range(3):
                ns = barrier.next_from(b, f)
                lo = np.searchsorted(don_pos, b + 1)
                hi = np.searchsorted(don_pos, min(ns + 3 if ns < 2 * n
                                                  else n, b + max_exon_len))
                for d in don_pos[lo:hi][:donors_per_site].tolist():
                    emit(b, d - 1, INTERNAL, f)
                if ns < 2 * n:
                    emit(b, ns + 2, TERMINAL, f)
    return dedupe(out)


def dedupe(cands: List[ExonCandidate]) -> List[ExonCandidate]:
    seen = set()
    out = []
    for c in cands:
        k = c.key()
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out
