"""GC-content decomposition and per-base class index ("stairs").

Replicates the behavior of the reference BaseCount / ContentDecomposition /
ContentStairs machinery (src/motif.cc:30-640, include/motif.hh:33-166) with
vectorized NumPy: a sliding window of nucleotide frequencies is classified to
the nearest of ``decomp_num_steps * decomp_num_at * decomp_num_gc`` target
compositions, followed by a smoothing pass that removes class stretches
shorter than 1000bp flanked by a common class.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import Constants
from ..properties import Properties


@dataclass
class Decomposition:
    """Target base compositions, one per GC class."""
    comps: np.ndarray            # (n_classes, 4) target freqs a,c,g,t
    weighing_type: int = 1       # 1 equal, 2 gc classes, 3 multinormal kernel
    weight_matrix: Optional[np.ndarray] = None   # (4,4) for type 3

    @property
    def n_classes(self) -> int:
        return self.comps.shape[0]


def make_decomposition(cn: Constants, props: Optional[Properties] = None
                       ) -> Decomposition:
    """Compute the target compositions (reference makeDecomposition,
    src/motif.cc: quot=1.25 skew grid over at/gc)."""
    quot = 1.25
    a, b, steps = cn.decomp_num_at, cn.decomp_num_gc, cn.decomp_num_steps
    comps = np.zeros((steps * a * b, 4))
    for i in range(steps):
        gc = cn.gc_range_min + (cn.gc_range_max - cn.gc_range_min) * (i + 1) / (steps + 1)
        at = 1 - gc
        for e in range(a):
            for f in range(b):
                quot_at = (2 - quot) + (2 * (quot - 1)) * (e + 1) / (a + 1)
                quot_cg = (2 - quot) + (2 * (quot - 1)) * (f + 1) / (b + 1)
                row = a * b * i + e * b + f
                comps[row, 0] = at / (1 + quot_at)        # a
                comps[row, 3] = at / (1 + 1 / quot_at)    # t
                comps[row, 1] = gc / (1 + quot_cg)        # c
                comps[row, 2] = gc / (1 + 1 / quot_cg)    # g

    wtype = 1
    wmat = None
    if props is not None:
        wtype = props.get_int("/BaseCount/weighingType", 1)
        if wtype == 3:
            fname = props.get("/BaseCount/weightMatrixFile", "")
            if fname:
                path = os.path.join(props.species_dir(), fname)
                toks = []
                with open(path) as fh:
                    for raw in fh:
                        line = raw.split("#", 1)[0].strip()
                        if line:
                            toks.extend(line.split())
                wmat = np.array([float(t) for t in toks[:16]]).reshape(4, 4)
    return Decomposition(comps=comps, weighing_type=wtype, weight_matrix=wmat)


def _classify(freqs: np.ndarray, decomp: Decomposition) -> np.ndarray:
    """Nearest class per row of freqs (n,4) under the configured weighting.

    Reference getNearestBaseCountIndex maximizes weight with a strictly-greater
    update, i.e. first index wins ties.
    """
    if decomp.n_classes == 1:
        return np.zeros(freqs.shape[0], dtype=np.int32)
    if decomp.weighing_type == 3 and decomp.weight_matrix is not None:
        # weight = 1 + 9 exp(-z M z^T): maximizing it == minimizing z M z^T
        # with z = f - c_k.  Expanding, z M z^T = f M f^T - f(M+M^T)c_k^T
        # + c_k M c_k^T; the f M f^T term is class-independent, so the
        # argmin reduces to an affine form per class — one (n,4)@(4,cls)
        # matmul instead of an (n,cls,4) einsum.
        M = decomp.weight_matrix
        C = decomp.comps                                    # (cls, 4)
        B = (M + M.T) @ C.T                                 # (4, cls)
        a = np.einsum("cj,jk,ck->c", C, M, C)               # (cls,)
        q = a[None, :] - freqs @ B                          # (n, cls)
        out = np.argmin(q, axis=1).astype(np.int32)
        # near-ties (symmetric windows hit them exactly): the affine
        # rounding can break them differently than the quadratic the
        # reference evaluates — recompute just those rows exactly
        part = np.partition(q, 1, axis=1)
        tie = np.flatnonzero(part[:, 1] - part[:, 0] < 1e-9)
        if tie.size:
            z = freqs[tie, None, :] - decomp.comps[None, :, :]
            qe = np.einsum("ncj,jk,nck->nc", z, decomp.weight_matrix, z)
            out[tie] = np.argmin(qe, axis=1).astype(np.int32)
        return out
    if decomp.weighing_type == 2:
        # same-gc-class indicator; ties resolved to the first max
        gc1 = freqs[:, 1] + freqs[:, 2]
        gc2 = decomp.comps[:, 1] + decomp.comps[:, 2]
        cls1 = _gc_content_class(gc1)
        cls2 = _gc_content_class(gc2)
        same = cls1[:, None] == cls2[None, :]
        return np.argmax(same, axis=1).astype(np.int32)
    # equal weights: all weights are 1 -> first index always wins
    return np.zeros(freqs.shape[0], dtype=np.int32)


def _gc_content_class(gc: np.ndarray) -> np.ndarray:
    # reference BaseCount::gcContentClass: 10 equal classes on [0,1]
    return np.clip((gc * 10).astype(np.int32), 0, 9)


def compute_stairs(codes: np.ndarray, cn: Constants, decomp: Decomposition
                   ) -> np.ndarray:
    """Per-base GC class index (reference ContentStairs::computeStairs)."""
    n = codes.shape[0]
    if decomp.n_classes == 1:
        return np.zeros(n, dtype=np.int32)
    win = cn.gc_win_size
    if win > n or win < 1:
        win = n

    onehot = np.zeros((n + 1, 4), dtype=np.int64)
    for b in range(4):
        onehot[1:, b] = codes == b
    cum = np.cumsum(onehot, axis=0)   # cum[i] = counts in codes[:i]

    lo = win // 2          # window of position i: [i - lo, i + hi - 1]
    hi = (win + 1) // 2

    idx = np.zeros(n, dtype=np.int32)

    first_counts = (cum[win] - cum[0]).astype(np.float64)
    s = first_counts.sum()
    first_freqs = first_counts / s if s > 0 else np.full(4, 0.25)
    first_cls = _classify(first_freqs[None, :], decomp)[0]
    idx[: lo + 1] = first_cls

    mid_lo, mid_hi = lo + 1, n - hi    # i in [mid_lo, mid_hi] inclusive
    if mid_hi >= mid_lo:
        s0 = mid_lo - lo        # contiguous run: slice, don't gather
        nm = mid_hi - mid_lo + 1
        counts = (cum[s0 + win: s0 + win + nm]
                  - cum[s0: s0 + nm]).astype(np.float64)
        sums = counts.sum(axis=1)
        freqs = np.where(sums[:, None] > 0, counts / np.maximum(sums, 1)[:, None],
                         first_freqs[None, :])
        idx[mid_lo: mid_hi + 1] = _classify(freqs, decomp)
        last_cls = idx[mid_hi]
    else:
        last_cls = first_cls
    idx[n - hi + 1:] = last_cls

    # tottery smoothing: flatten short (<1000bp) stretches flanked by one class
    tottery = 1000
    # sequential over change points only (cheap: few class switches)
    change = np.flatnonzero(np.diff(idx)) + 1
    points = [0] + change.tolist()
    x = -2
    last_step = 0
    for i in points:
        if idx[i] != x:
            if i - last_step < tottery and last_step > 0 and idx[last_step - 1] == idx[i]:
                idx[last_step:i] = idx[i]
            last_step = i
            x = idx[i]
    return idx
