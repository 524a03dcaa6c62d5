"""Per-species exon DAG + longest path for CGP.

Reference: src/speciesgraph.cc (SpeciesGraph::buildGraph :14, topological
sort + relax :838-921) — a DAG over sampled-transcript exons plus extra
exon candidates, whose longest path is one species' gene structure; dual
decomposition (orthograph) perturbs node weights between iterations.

Here the node set is the species' Viterbi-decode exons (carrying the full
GHMM signal through the device engines) plus CGP exon candidates; node
base weights are content log-odds + splice/start/stop signal scores from
the prepared gold-engine tracks, with a logistic-regression-style offset
(reference cgp ExonScore features, train_logReg_param.cc); the longest
path over chain-compatible exons (frame continuity, intron length
bounds) is a simple O(E) DP after sorting — graphs are tiny.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .exoncand import (ExonCandidate, INITIAL, INTERNAL, SINGLE, TERMINAL,
                       dedupe)

MIN_INTRON = 39
MAX_INTRON = 30000       # chain-scan window (gene ranges are <~500kb)
# logistic-regression-ish weights (reference
# config/cgp/log_reg_parameters_default.txt: intercept + per-feature).
# The intercept keeps random open intervals negative so chains prefer
# decode-supported and phylogenetically supported exons.
W_INTERCEPT = -12.0
W_LEN = 0.0


@dataclass
class PathNode:
    ec: ExonCandidate
    base: float                    # species-intrinsic log score
    bonus: float = 0.0             # dual-decomposition multiplier term
    support: float = 0.0           # phylo support (for the score column)
    hects: List[int] = field(default_factory=list)


def score_candidates(eng, cands: List[ExonCandidate]) -> List[PathNode]:
    """Intrinsic per-exon log-odds from the prepared gold-engine tracks:
    coding-chain vs intergenic-chain content over the exon span + splice /
    start / stop signal log-probs at the boundaries (reference scores ECs
    via sampling posteriors + logreg features; this is the ab-initio
    feature subset)."""
    n = eng.n
    nodes: List[PathNode] = []
    stairs = eng.stairs
    # cumulative intergenic chain per class
    ig_cum = {c: np.concatenate([[0.0], np.cumsum(v)])
              for c, v in eng.ig_track.items()}
    for ec in cands:
        b, e = ec.begin, ec.end
        if b < 0 or e >= n or e <= b:
            continue
        c = int(stairs[min(b, n - 1)])
        fwd = ec.strand == "+"
        cum = eng.cum_exon[(c, "emi", fwd)]
        # content log-odds at the best of the 3 phases: candidate frames
        # are resolved by the chain DP, the best-phase score ranks the
        # exon without per-candidate frame bookkeeping
        seg = max(float(cum[ph, e + 1] - cum[ph, b]) for ph in range(3))
        ig = ig_cum[c][e + 1] - ig_cum[c][b]
        sc = float(seg - ig)
        sp = eng.splice
        sig = 0.0
        if ec.etype in (INTERNAL, TERMINAL):
            asc = sp.ass_score[c] if fwd else sp.rass_score[c]
            pos = b - 1 if fwd else e + 1
            if 0 <= pos < n and np.isfinite(asc[min(pos, asc.shape[0] - 1)]):
                sig += float(np.clip(asc[min(pos, asc.shape[0] - 1)] + 12.0,
                                     -10.0, 4.0))
        if ec.etype in (INITIAL, INTERNAL):
            dsc = sp.dss_score if fwd else sp.rdss_score
            pos = e + 1 if fwd else b - 1
            if 0 <= pos < n and np.isfinite(dsc[min(pos, dsc.shape[0] - 1)]):
                sig += float(np.clip(dsc[min(pos, dsc.shape[0] - 1)] + 8.0,
                                     -10.0, 4.0))
        base = W_INTERCEPT + sc + sig + W_LEN * (e - b + 1)
        nodes.append(PathNode(ec=ec, base=base))
    return nodes


_CHAIN_OK = {
    (INITIAL, INTERNAL), (INITIAL, TERMINAL),
    (INTERNAL, INTERNAL), (INTERNAL, TERMINAL),
}
_START_TYPES = (SINGLE, INITIAL)
_END_TYPES = (SINGLE, TERMINAL)


def _chainable(u: ExonCandidate, v: ExonCandidate, n: int) -> bool:
    """u before v in transcription order (strand-aware), frame-continuous,
    intron length within bounds (reference SpeciesGraph edge rules)."""
    if u.strand != v.strand:
        return False
    if u.strand == "+":
        a, bseq = u, v
        ut, vt = u.etype, v.etype
        ulen = u.end - u.begin + 1
        uframe = u.frame
        vframe = v.frame
    else:
        a, bseq = u, v            # coordinates still increase left->right
        # on '-', transcription runs right to left: v (left) FOLLOWS u
        ut, vt = u.etype, v.etype
        ulen = u.end - u.begin + 1
        uframe = u.frame
        vframe = v.frame
    gap = bseq.begin - a.end - 1
    if gap < MIN_INTRON or gap > MAX_INTRON:
        return False
    if u.strand == "+":
        if (ut, vt) not in _CHAIN_OK:
            return False
        if vframe != (uframe + ulen) % 3:
            return False
    else:
        # left neighbour v is the LATER exon: chain types reversed
        if (vt, ut) not in _CHAIN_OK:
            return False
        vlen = v.end - v.begin + 1
        if uframe != (vframe + vlen) % 3:
            return False
    return True


@functools.lru_cache(maxsize=8)
def _edges(ecs: Tuple[ExonCandidate, ...]):
    """(chain, far) (N, N) boolean tables over the candidates `ecs` in
    (begin, end) order: chain[oi, oj] is _chainable(ecs[oj], ecs[oi]),
    far[oi, oj] that the gap from ecs[oj]'s end to ecs[oi]'s begin passes
    MAX_INTRON; the rules of _chainable, evaluated for all pairs at once
    (dual_decomp asks for the same graph at every iteration)."""
    b = np.array([ec.begin for ec in ecs], dtype=np.int64)
    e = np.array([ec.end for ec in ecs], dtype=np.int64)
    t = np.array([ec.etype for ec in ecs], dtype=np.int64)
    f = np.array([ec.frame for ec in ecs], dtype=np.int64)
    plus = np.array([ec.strand == "+" for ec in ecs])
    strand = np.array([ec.strand for ec in ecs])
    ok = np.zeros((4, 4), dtype=bool)
    for u, v in _CHAIN_OK:
        ok[u, v] = True
    ln = e - b + 1
    gap = b[:, None] - e[None, :] - 1                 # [v = oi, u = oj]
    same = strand[:, None] == strand[None, :]
    fwd = ok[t[None, :], t[:, None]] & \
        (f[:, None] == (f[None, :] + ln[None, :]) % 3)
    rev = ok[t[:, None], t[None, :]] & \
        (f[None, :] == (f[:, None] + ln[:, None]) % 3)
    chain = same & (gap >= MIN_INTRON) & (gap <= MAX_INTRON) & \
        np.where(plus[:, None], fwd, rev)
    return chain, gap > MAX_INTRON


def longest_paths(nodes: List[PathNode], n: int,
                  max_genes: int = 12) -> List[List[PathNode]]:
    """Best chains by total weight, greedily extracted without overlap
    (reference runs one global longest path over the DAG with a neutral
    line; iterated extraction gives the same multi-gene effect).

    The chain of node oi takes, of the nodes before it in (begin, end)
    order walked back from oi - 1, the first one of the largest score
    dp[oj] + w that beats its own start, up to the first live node whose
    gap passes MAX_INTRON (augustus_tpu's walk, one predecessor at a time;
    here each node's walk is one pass over the tables of _edges)."""
    order = sorted(range(len(nodes)),
                   key=lambda i: (nodes[i].ec.begin, nodes[i].ec.end))
    genes: List[List[PathNode]] = []
    used = np.zeros(n + 1, dtype=bool)
    chain_t, far_t = _edges(tuple(nodes[i].ec for i in order))

    for _ in range(max_genes):
        dp = np.full(len(order), -np.inf)
        back: List[int] = [-1] * len(order)
        for oi, i in enumerate(order):
            nd = nodes[i]
            ec = nd.ec
            if used[ec.begin: ec.end + 1].any():
                continue
            w = nd.base + nd.bonus
            start_ok = (ec.etype in _START_TYPES) if ec.strand == "+" \
                else (ec.etype in _END_TYPES)
            best = w if start_ok else -np.inf
            bi = -1
            if oi:
                d = dp[oi - 1:: -1]                     # oj = oi - 1 .. 0
                live = d != -np.inf
                stop = np.flatnonzero(live & far_t[oi, oi - 1:: -1])
                k0 = int(stop[0]) if stop.size else oi
                take = np.flatnonzero(live[:k0] &
                                      chain_t[oi, oi - 1:: -1][:k0])
                if take.size:
                    cand = d[take] + w
                    k = int(np.argmax(cand))            # its first maximum
                    if cand[k] > best:
                        best, bi = cand[k], oi - 1 - int(take[k])
            dp[oi] = best
            back[oi] = bi
        # best complete chain
        best_v, best_i = 0.0, -1
        for oi, i in enumerate(order):
            if dp[oi] == -np.inf:
                continue
            ec = nodes[i].ec
            end_ok = (ec.etype in _END_TYPES) if ec.strand == "+" \
                else (ec.etype in _START_TYPES)
            if end_ok and dp[oi] > best_v:
                best_v, best_i = dp[oi], oi
        if best_i < 0:
            break
        chain: List[PathNode] = []
        oi = best_i
        while oi >= 0:
            chain.append(nodes[order[oi]])
            oi = back[oi]
        chain.reverse()
        genes.append(chain)
        for nd in chain:
            used[nd.ec.begin: nd.ec.end + 1] = True
    return genes
