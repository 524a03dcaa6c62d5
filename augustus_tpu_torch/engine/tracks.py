"""Per-sequence dense log-score tracks (host copy of
augustus_tpu/engine/tracks.py, numpy only).

Instead of evaluating emission
probabilities lazily per DP candidate (reference: ExonModel::seqProb
src/exonmodel.cc:1925, SnippetProbs/SegProbs include/statemodel.hh:182-256),
we precompute for the whole sequence

  * per-base content log-emissions for every model / strand / frame-phase,
    plus their prefix sums -> any segment emission is O(1),
  * windowed signal-sensor scores (donor/acceptor splice sites, translation
    initiation, stop codons) as dense tracks,
  * open-reading-frame stop barriers (nearest in-frame stop per frame/strand).

Everything is float64 log space on the host; the Viterbi kernel consumes the
same tracks as float32 device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .. import genetics
from ..constants import Constants, ASS_MIDDLE, DSS_MIDDLE, STOPCODON_LEN
from ..model.pbl import IntronParams, Motif
from .xputil import DD, asarr, ftype

NEG_INF = float("-inf")
LOG_QUARTER = float(np.log(0.25))


def _safe_log(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(x)


def _safe_log_np(x: np.ndarray) -> np.ndarray:
    """Always-host log of a model-constant table."""
    with np.errstate(divide="ignore"):
        return np.log(x)


def kmer_lookup_log(codes: np.ndarray, k1: int, table: np.ndarray,
                    invalid_log: float) -> np.ndarray:
    """log table[pattern ending at j] for j in [k1-1, n-1]; positions j<k1-1
    and windows containing N get `invalid_log`.  Returns full length n."""
    xp = np
    n = codes.shape[0]
    if n < k1:
        return np.full(n, invalid_log)
    ids = genetics.kmer_ids(codes, k1)          # pattern starting at i
    valid = ids >= 0
    logs = xp.where(valid, _safe_log(asarr(table)[xp.where(valid, ids, 0)]),
                    invalid_log)
    head = xp.full((k1 - 1,), invalid_log, dtype=ftype())
    return xp.concatenate([head, logs])          # ends at j = i + k1 - 1


def rc_kmer_lookup_log(codes: np.ndarray, k1: int, table: np.ndarray,
                       invalid_log: float) -> np.ndarray:
    """log table[rc pattern starting at j] for j in [0, n-k1]; tail positions
    (window crossing the end) and N windows get `invalid_log`."""
    xp = np
    n = codes.shape[0]
    if n < k1:
        return np.full(n, invalid_log)
    ids = genetics.rc_kmer_ids(codes, k1)
    valid = ids >= 0
    logs = xp.where(valid, _safe_log(asarr(table)[xp.where(valid, ids, 0)]),
                    invalid_log)
    tail = xp.full((k1 - 1,), invalid_log, dtype=ftype())
    return xp.concatenate([logs, tail])


def phase_cumsum(per_frame: np.ndarray, reverse: bool):
    """Build prefix sums for the 3 frame phases.

    per_frame: (3, n) log emission of position j if its frame were f.
    Returns cum: (3, n+1) with cum[phi, j+1] = sum_{i<=j} per_frame[frame(phi,i), i]
    where frame(phi,i) = (phi+i)%3 forward, (phi-i)%3 reverse.

    Host: plain float64 ndarray.  Device tracing: a DD double-float32 pair
    (the raw cums reach O(1.4e6) at megabase scale; f32 alone would rebase
    with ~0.06 absolute noise — see xputil.DD).
    """
    from . import xputil as U
    xp = np
    _, n = per_frame.shape
    pos = U.arange(n)
    rows = []
    z = xp.zeros((1,), dtype=ftype())
    for phi in range(3):
        f = (phi + pos) % 3 if not reverse else (phi - pos) % 3
        # row select instead of a 2D gather (same values)
        sel = xp.where(f == 0, per_frame[0],
                       xp.where(f == 1, per_frame[1], per_frame[2]))
        rows.append(xp.concatenate([z, sel]))
    cum = DD.cumsum_dd(xp.stack(rows), axis=-1)
    return cum.hi


def motif_score_fwd(codes: np.ndarray, motif: Motif) -> np.ndarray:
    """log Motif::seqProb(seq + s) for every window start s (forward,
    non-complement): product over window positions i of
    windowProbs[i][pattern ending at s+i spanning [s+i-k, s+i]].
    Window positions whose pattern contains N or crosses the sequence end
    contribute 0.25 (reference Motif::seqProb per-position catch).
    Defined for s in [k, n-1]; s < k gets -inf (callers gate on that)."""
    xp = np
    n = codes.shape[0]
    k1 = motif.k + 1
    if n <= motif.k:
        return np.full(n, NEG_INF)
    ids_part = genetics.kmer_ids(codes, k1)     # start i -> [i, i+k]
    ids = xp.concatenate([ids_part, xp.full((n - ids_part.shape[0],), -1,
                                            dtype=ids_part.dtype)])
    from . import xputil as U
    sfull = U.arange(n)
    # ONE (n)-index gather pulling all n_win window rows per pattern id
    # (per-row gathers were the dominant prep-graph cost: ~5 ms + launch
    # overhead each, x n_win x calls); shift∘lookup == lookup∘shift under
    # edge-clipped shifts, and the add order below is unchanged, so the
    # result is bit-identical to the per-row formulation
    logw_t = asarr(_safe_log_np(motif.window_probs).T)   # (4^{k+1}, n_win)
    G = logw_t[xp.clip(ids, 0, None)].T                  # (n_win, n)
    valid = ids >= 0
    acc = xp.zeros(n, dtype=ftype())
    for i in range(motif.n):
        sh = i - motif.k
        v = ((sfull + sh) <= n - 1) & U.sg(valid, sh, n)
        acc = acc + xp.where(v, U.sg(G[i], sh, n), LOG_QUARTER)
    return xp.where(sfull >= motif.k, acc, NEG_INF)


def motif_score_rc(codes: np.ndarray, motif: Motif) -> np.ndarray:
    """log Motif::seqProb(seq + s, reverse=True, complement=True) per start s:
    product over i of windowProbs[n-1-i][rc pattern starting at s+i]; window
    positions crossing the end or containing N contribute 0.25."""
    xp = np
    n = codes.shape[0]
    k1 = motif.k + 1
    if n == 0:
        return np.full(n, NEG_INF)
    ids_part = genetics.rc_kmer_ids(codes, k1)  # start i -> rc of [i, i+k]
    ids = xp.concatenate([ids_part, xp.full((n - ids_part.shape[0],), -1,
                                            dtype=ids_part.dtype)]) \
        if ids_part.shape[0] < n else ids_part
    from . import xputil as U
    sfull = U.arange(n)
    # single fat gather + shifted-column adds; bit-identical to the
    # per-row gathers (see motif_score_fwd)
    logw_t = asarr(_safe_log_np(motif.window_probs).T)   # (4^{k+1}, n_win)
    G = logw_t[xp.clip(ids, 0, None)].T                  # (n_win, n)
    valid = ids >= 0
    acc = xp.zeros(n, dtype=ftype())
    for i in range(motif.n):
        v = ((sfull + i) <= n - 1) & U.sg(valid, i, n)
        acc = acc + xp.where(v, U.sg(G[motif.n - 1 - i], i, n), LOG_QUARTER)
    return acc


@dataclass
class SpliceTracks:
    dss_ok: np.ndarray          # "gt" (or "gc") starting at pos
    rdss_ok: np.ndarray         # "ac" starting at pos
    ass_ok: np.ndarray          # "ag" starting at pos
    rass_ok: np.ndarray         # "ct" starting at pos
    dss_score: np.ndarray       # log dSSProb(base, fwd)
    rdss_score: np.ndarray      # log dSSProb(base, rev)
    ass_score: List[np.ndarray]   # per GC class: log aSSProb(base, fwd)
    rass_score: List[np.ndarray]  # per GC class: log aSSProb(base, rev)


def dinuc_at(codes: np.ndarray, a: int, b: int) -> np.ndarray:
    xp = np
    n = codes.shape[0]
    head = (codes[:-1] == a) & (codes[1:] == b)
    return xp.concatenate([head, xp.zeros(min(n, 1), dtype=bool)])


def is_possible_dss_sh(dss_ok: np.ndarray, c: int) -> np.ndarray:
    """is_possible_dss at pos = i + c (static shift; slice not gather)."""
    from . import xputil as U
    n = dss_ok.shape[0]
    pos = U.arange(n) + c
    ok = (pos >= 1) & (pos <= n - 2)
    return ok & U.sg(dss_ok, c, n)


def is_possible_rdss_sh(rdss_ok: np.ndarray, c: int) -> np.ndarray:
    from . import xputil as U
    n = rdss_ok.shape[0]
    pos = U.arange(n) + c
    ok = (pos >= 1) & (pos <= n - 2)
    return ok & U.sg(rdss_ok, c - 1, n)


def is_possible_ass_sh(ass_ok: np.ndarray, c: int) -> np.ndarray:
    from . import xputil as U
    n = ass_ok.shape[0]
    pos = U.arange(n) + c
    ok = (pos >= 1) & (pos <= n - 2)
    return ok & U.sg(ass_ok, c - 1, n)


def is_possible_rass_sh(rass_ok: np.ndarray, c: int) -> np.ndarray:
    from . import xputil as U
    n = rass_ok.shape[0]
    pos = U.arange(n) + c
    ok = (pos >= 1) & (pos <= n - 2)
    return ok & U.sg(rass_ok, c, n)


def is_possible_dss(dss_ok: np.ndarray, pos) -> np.ndarray:
    """reference StateModel::isPossibleDSS: 1 <= pos <= n-2 and consensus
    'gt' at [pos, pos+1] (hints add sites later)."""
    n = dss_ok.shape[0]
    ok = (pos >= 1) & (pos <= n - 2)
    return ok & dss_ok[np.clip(pos, 0, n - 1)]


def build_splice_tracks(codes: np.ndarray, ip: IntronParams, cn: Constants
                        ) -> SpliceTracks:
    xp = np
    n = codes.shape[0]
    A_, C_, G_, T_ = genetics.A, genetics.C, genetics.G, genetics.T

    dss_ok = dinuc_at(codes, G_, T_)
    if cn.dss_gc_allowed:
        dss_ok = dss_ok | dinuc_at(codes, G_, C_)
    rdss_ok = dinuc_at(codes, A_, C_)
    if cn.dss_gc_allowed:
        rdss_ok = rdss_ok | dinuc_at(codes, G_, C_)
    ass_ok = dinuc_at(codes, A_, G_)
    rass_ok = dinuc_at(codes, C_, T_)

    from . import xputil as U
    ds, de = cn.dss_start, cn.dss_end
    base = U.arange(n)

    from . import xputil as U
    c64 = codes.astype(np.int64)
    comp_t = asarr(genetics.COMPLEMENT)
    comp64 = comp_t[codes].astype(np.int64)
    pos_i = U.arange(n)

    def window_ids(offsets):
        """Pattern id from STATIC integer offsets (big-endian), -1 where
        any base is N or out of range; shifts instead of gathers."""
        ids = xp.zeros(n, dtype=np.int64 if xp is np else np.int32)
        bad = xp.zeros(n, dtype=bool)
        for off in offsets:
            inr = (pos_i + off >= 0) & (pos_i + off < n)
            c = xp.where(inr, U.sg(c64, off, n), np.int64(genetics.N))
            bad = bad | (c == genetics.N)
            ids = (ids << 2) | xp.where(c == genetics.N, 0, c)
        return xp.where(bad, -1, ids)

    def rc_ids(offsets):
        # complement bases, given in already-reversed offset order
        ids = xp.zeros(n, dtype=np.int64 if xp is np else np.int32)
        bad = xp.zeros(n, dtype=bool)
        for off in offsets:
            inr = (pos_i + off >= 0) & (pos_i + off < n)
            c = xp.where(inr, U.sg(comp64, off, n), np.int64(genetics.N))
            bad = bad | (c == genetics.N)
            ids = (ids << 2) | xp.where(c == genetics.N, 0, c)
        return xp.where(bad, -1, ids)

    # Pre-binned pattern tables, computed ONCE per model in float64 on the
    # host: the piecewise-constant bin factor is a pure function of the
    # pattern id (+ the non-consensus flag), so gathering a host-binned
    # table keeps device f32 runs bit-consistent with the host's f64
    # binning even for probabilities that sit exactly on bin boundaries
    # (the .pbl files contain such values).
    if not hasattr(ip, "_binned_tables"):
        def _host_factor(bin_, p):
            if bin_.nbins == 0:
                return p
            return np.asarray(bin_.avprobs)[
                np.searchsorted(np.asarray(bin_.boundaries), p,
                                side="right")]
        with np.errstate(divide="ignore"):
            dssp = np.asarray(ip.dss_probs, dtype=np.float64)
            assp = np.asarray(ip.ass_probs, dtype=np.float64)
            ip._binned_tables = (
                np.log(_host_factor(ip.dss_bin, dssp)),
                np.log(_host_factor(ip.dss_bin, dssp * ip.non_gt_dss_prob)),
                np.log(_host_factor(ip.ass_bin, assp)),
                np.log(_host_factor(ip.ass_bin, assp * ip.non_ag_ass_prob)))
    log_dssb, log_dssb_n, log_assb, log_assb_n = \
        [asarr(t) for t in ip._binned_tables]

    # forward DSS: possible at base if isPossibleDSS(base+dss_start) and the
    # whole window [base, base+dss_whole-1] is inside the sequence
    whole = cn.dss_whole_size
    okb = (base + whole <= n) & is_possible_dss_sh(dss_ok, ds)
    offs = [i for i in range(ds)] + \
           [ds + DSS_MIDDLE + i for i in range(de)]
    pid = window_ids(offs)
    valid = pid >= 0
    pc = xp.where(valid, pid, 0)
    non_gt = ~U.sg(dinuc_at(codes, G_, T_), ds, n)
    lp = xp.where(non_gt, log_dssb_n[pc], log_dssb[pc])
    dss_score = xp.where(okb & valid, lp, NEG_INF)

    # reverse DSS window starting at base: [base, base+dss_end-1], "ac" at
    # [base+dss_end, +1], [base+dss_end+2, base+dss_whole-1]; the pattern is
    # the reverse complement read: first the rc of the right part then rc of
    # the left part (reference dSSProb, reverse branch).
    okb = (base + whole <= n) & is_possible_rdss_sh(rdss_ok, de + 1)
    offs = [de + DSS_MIDDLE + ds - 1 - i for i in range(ds)] + \
           [de - 1 - i for i in range(de)]
    pid = rc_ids(offs)
    valid = pid >= 0
    pc = xp.where(valid, pid, 0)
    non_gt = ~U.sg(dinuc_at(codes, A_, C_), de, n)
    lp = xp.where(non_gt, log_dssb_n[pc], log_dssb[pc])
    rdss_score = xp.where(okb & valid, lp, NEG_INF)

    # ---- acceptor (ASS) ----------------------------------------------------
    asz, ae = cn.ass_start, cn.ass_end
    up = cn.ass_upwindow_size
    ass_whole = cn.ass_whole_size
    ass_score = []
    rass_score = []
    inv_lp = np.log(0.001) + cn.ass_size * LOG_QUARTER
    for gcp in ip.gc:
        motif_f = motif_score_fwd(codes, gcp.ass_motif)
        motif_r = motif_score_rc(codes, gcp.ass_motif)

        # forward: window [base, base+up+ass_whole-1]; "ag" at
        # [base+up+ass_start, +1]; pattern = [base+up, +ass_start-1] +
        # [base+up+ass_start+2, ...+ae-1]; motif over [base, base+up-1]
        okb = (base + up + ass_whole <= n) & \
            is_possible_ass_sh(ass_ok, up + asz + 1)
        offs = [up + i for i in range(asz)] + \
               [up + asz + ASS_MIDDLE + i for i in range(ae)]
        pid = window_ids(offs)
        valid = pid >= 0
        pc = xp.where(valid, pid, 0)
        non_ag = ~U.sg(dinuc_at(codes, A_, G_), up + asz, n)
        lpv = xp.where(non_ag, log_assb_n[pc], log_assb[pc])
        lp = xp.where(valid, lpv, inv_lp)
        # motifProb = 0 when base < motif.k (reference aSSProb)
        mot = xp.where(base >= gcp.ass_motif.k, motif_f, NEG_INF)
        ass_score.append(xp.where(okb, lp + mot, NEG_INF))

        # reverse: "ct" at [base+ae, +1]; pattern rc; motif over
        # [base+ass_whole, +up-1] in rc orientation
        okb = (base + up + ass_whole <= n) & \
            is_possible_rass_sh(rass_ok, ae)
        offs = [ae + ASS_MIDDLE + asz - 1 - i for i in range(asz)] + \
               [ae - 1 - i for i in range(ae)]
        pid = rc_ids(offs)
        valid = pid >= 0
        pc = xp.where(valid, pid, 0)
        non_ag = ~U.sg(dinuc_at(codes, C_, T_), ae, n)
        lpv = xp.where(non_ag, log_assb_n[pc], log_assb[pc])
        lp = xp.where(valid, lpv, inv_lp)
        motifend = base + ass_whole + up
        mot = xp.where(motifend + gcp.ass_motif.k < n,
                       U.sg(motif_r, ass_whole, n), up * LOG_QUARTER)
        rass_score.append(xp.where(okb, lp + mot, NEG_INF))

    return SpliceTracks(dss_ok=dss_ok, rdss_ok=rdss_ok, ass_ok=ass_ok,
                        rass_ok=rass_ok, dss_score=dss_score,
                        rdss_score=rdss_score, ass_score=ass_score,
                        rass_score=rass_score)


def nearest_stop_arrays(codes: np.ndarray, code: genetics.GeneticCode
                        ) -> Dict[str, np.ndarray]:
    """reference OpenReadingFrame ctor (src/exonmodel.cc:167): per position i
    (stepping by 3 within each frame lane), the largest stop-codon start
    <= i in the same lane; -1 if none.  Plus the tail fixups."""
    xp = np
    n = codes.shape[0]
    stops_f = code.stop_at(codes)
    stops_r = code.rc_stop_at(codes)
    limit = n - STOPCODON_LEN
    fwd = np.full(n, -1, dtype=np.int64)
    rev = np.full(n, -1, dtype=np.int64)
    for lane in range(3):
        pos = np.arange(lane, limit + 1, 3)
        if pos.size == 0:
            continue
        for arr, stops in ((fwd, stops_f), (rev, stops_r)):
            hit = np.where(np.asarray(stops)[pos], pos, -1)
            arr[pos] = np.maximum.accumulate(hit)
    if n > 5:
        fwd[limit + 1] = fwd[limit - 2]
        fwd[limit + 2] = fwd[limit - 1]
        rev[limit + 1] = rev[limit - 2]
        rev[limit + 2] = rev[limit - 1]
    return {"fwd": fwd, "rev": rev}


def leftmost_exon_begin(orf: Dict[str, np.ndarray], frame, base, forward: bool,
                        cn: Constants, n: int):
    """reference OpenReadingFrame::leftmostExonBegin (vectorized)."""
    xp = np
    if forward:
        pos = xp.where((frame == 0) | (frame == 1), base - frame - 3,
                       base - frame)
    else:
        pos = xp.where((frame == 1) | (frame == 2), base + frame - 5,
                       base - 2)
    pos = xp.where(pos >= n, pos - 3 * ((pos - n + 3) // 3), pos)
    arr = orf["fwd"] if forward else orf["rev"]
    leftmost = xp.where(pos >= 0, arr[xp.clip(pos, 0, n - 1)] + 1, 0)
    max_allowed = (cn.max_exon_len - cn.ass_upwindow_size - cn.ass_start
                   - ASS_MIDDLE - DSS_MIDDLE - cn.dss_start)
    return xp.maximum(leftmost, base - max_allowed)

