"""Trainable positional weight-array motifs (reference Motif, src/motif.cc).

A motif of length n with memory k holds, per window position, counts over all
(k+1)-mers; neighbor smearing distributes each observation to +-radius
positions.  Sequences are numpy int8 code arrays (genetics.encode).

Port of `augustus_tpu/training/motif.py`: host numpy, no kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import genetics
from .fmt import g as fmtg, setw


class Motif:
    def __init__(self, length: int, memory: int, pseudocount: int = 1,
                 neighbors: int = 0):
        self.n = length
        self.k = memory
        self.pseudocount = pseudocount
        self.neighbors = neighbors
        self.num_seqs = 0
        npat = 4 ** (memory + 1)
        self.window_counts = np.full((length, npat), pseudocount,
                                     dtype=np.int64)
        self.window_probs = np.zeros((length, npat), dtype=np.float64)

    def add_sequence(self, codes: np.ndarray, pos: int, weight: int = 1,
                     reverse: bool = False) -> None:
        """Add one training window; ``pos`` is the index of the first motif
        base in ``codes`` (reference Motif::addSequence, src/motif.cc:285).

        Forward: window position i uses the (k+1)-mer ending at pos+i
        (codes[pos+i-k .. pos+i]).  Reverse: the (k+1)-mer starting at pos+i
        read with reversed digit significance (Seq2Int::rev).
        """
        n, k = self.n, self.k
        for i in range(n):
            if reverse:
                win = codes[pos + i: pos + i + k + 1]
                if win.shape[0] < k + 1 or (win == genetics.N).any():
                    continue
                pn = 0
                for j in range(k + 1):
                    pn |= int(win[j]) << (2 * j)
            else:
                if pos + i - k < 0:
                    continue
                win = codes[pos + i - k: pos + i + 1]
                if win.shape[0] < k + 1 or (win == genetics.N).any():
                    continue
                pn = 0
                for j in range(k + 1):
                    pn = (pn << 2) | int(win[j])
            self.window_counts[i, pn] += weight
            for j in range(1, self.neighbors + 1):
                if i - j >= 0:
                    self.window_counts[i - j, pn] += weight
                if i + j < n:
                    self.window_counts[i + j, pn] += weight
        self.num_seqs += 1

    def make_probs(self) -> None:
        """Per-position conditional probabilities (Motif::makeProbs)."""
        counts = self.window_counts.reshape(self.n, -1, 4)
        sums = counts.sum(axis=2, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            probs = counts / sums
        probs = np.where(sums > 0, probs, 0.25)
        self.window_probs = probs.reshape(self.n, -1)

    def write(self, out: List[str]) -> None:
        """Append .pbl lines (reference Motif::write, src/motif.cc:373)."""
        out.append("# width of motif, n=")
        out.append(str(self.n))
        out.append("# order of markov model, k=")
        out.append(str(self.k))
        out.append("# markov chain emission probabilities")
        for i in range(self.n):
            row = "\t".join(fmtg(v) for v in self.window_probs[i])
            out.append(setw(str(i), 2) + "  " + row)
