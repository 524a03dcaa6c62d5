"""Count-to-probability estimation helpers.

Faithful equivalents of StateModel::determineShortPatterns /
makeProbsFromCounts / computeEmiFromPat (src/statemodel.cc:95-197).
Accumulation order of the C++ loops is preserved (float64 addition is not
associative and .pbl outputs are compared byte-exactly).

Port of `augustus_tpu/training/probs.py`: host numpy, no kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def determine_short_patterns(patcounts: np.ndarray, k: int,
                             min_count: int) -> np.ndarray:
    """shortpattern[midpn] = (sum over last base < minCount)."""
    if k < 2:
        return np.zeros(0, dtype=bool)
    c = patcounts.reshape(-1, 4).sum(axis=1)
    return c < min_count


def make_probs_from_counts(patcounts: np.ndarray, k: int, pseudocount: float,
                           shortpattern: Optional[np.ndarray] = None
                           ) -> np.ndarray:
    """Pattern probabilities with pseudocounts; optionally pool patterns
    flagged in ``shortpattern`` over their first base."""
    size = 4 ** (k + 1)
    assert patcounts.shape[0] == size
    patprobs = np.zeros(size, dtype=np.float64)
    normsum = 0.0
    if shortpattern is None or k < 2 or shortpattern.shape[0] == 0:
        for pn in range(0, size, 4):
            for i in range(4):
                v = float(patcounts[pn + i]) + pseudocount
                patprobs[pn + i] = v
                normsum += v
    else:
        shortsize = 4 ** (k - 1)
        for pn in range(shortpattern.shape[0]):
            if not shortpattern[pn]:
                for i in range(4):
                    v = float(patcounts[4 * pn + i]) + pseudocount
                    patprobs[4 * pn + i] = v
                    normsum += v
            else:
                midpn = pn % shortsize
                for b in range(4):
                    p = int(patcounts[4 * midpn + b]
                            + patcounts[4 * (shortsize + midpn) + b]
                            + patcounts[4 * (2 * shortsize + midpn) + b]
                            + patcounts[4 * (3 * shortsize + midpn) + b])
                    v = float(p) / 4 + pseudocount
                    patprobs[4 * pn + b] = v
                    normsum += v
    for pn in range(size):
        patprobs[pn] = patprobs[pn] / normsum
    return patprobs


def compute_emi_from_pat(patprobs: np.ndarray, k: int) -> np.ndarray:
    """Conditional emissions from pattern probabilities."""
    size = 4 ** (k + 1)
    emi = np.zeros(size, dtype=np.float64)
    for i in range(0, size, 4):
        s = ((float(patprobs[i]) + float(patprobs[i + 1]))
             + float(patprobs[i + 2])) + float(patprobs[i + 3])
        for nuk in range(4):
            emi[i + nuk] = (patprobs[i + nuk] / s) if k > 0 \
                else patprobs[i + nuk]
    return emi


def compute_lower_order_pats(pls_k: np.ndarray, k: int) -> list:
    """Pls[i] for i=0..k from Pls[k] by summing over the first base
    (reference ExonModel::computeLowerOrderPats / igenictrain.cc:125)."""
    pls = [None] * (k + 1)
    pls[k] = pls_k
    for i in range(k - 1, -1, -1):
        size = 4 ** (i + 1)
        cur = np.zeros(size, dtype=np.float64)
        nxt = pls[i + 1]
        for j in range(size):
            cur[j] = ((float(nxt[j]) + float(nxt[j + size]))
                      + float(nxt[j + 2 * size])) + float(nxt[j + 3 * size])
        pls[i] = cur
    return pls
