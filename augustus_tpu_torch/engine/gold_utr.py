"""UTR tracks of the host route (counterpart of
`augustus_tpu/engine/gold_utr.py`).

Implements the 24 UTR states (5'/3' × single/init/intron/intronvar/internal/
term × both strands) following the reference UtrModel
(src/utrmodel.cc: viterbiForwardAndSampling :796, getEndPositions :960,
endPartEmiProb :1010, notEndPartEmiProb :1060, tssProb :1760,
computeTtsProbs :1840).  Sensors (TSS with optional TATA box, TTS/polyA) are
precomputed as dense per-position tracks; exon-segment emissions come from
cumulative-sum tracks of the (intron-mixed) UTR content models.

The intronvar states only take candidates from intron *hints* in the
reference; without hints they are inert and are skipped here until the hints
subsystem lands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .. import genetics
from ..constants import Constants, ASS_MIDDLE, DSS_MIDDLE
from ..model.state_config import ST, is_on_f_strand
from ..model.pbl import UtrParams
from . import tracks as T

NEG_INF = float("-inf")
LOG_QUARTER = float(np.log(0.25))
TTS_SPACING = 10    # reference UtrModel::ttsSpacing (src/utrmodel.cc:122)


@dataclass
class UtrConfig:
    tss_start: int = 5
    tss_end: int = 4
    tata_start: int = 2
    tata_end: int = 10
    d_tss_tata_min: int = 26
    d_tss_tata_max: int = 37
    d_polyasig_cleavage: int = 20
    prob_polya: float = 0.9
    max_exon_length: int = 1500
    max3single: int = 5500
    max3term: int = 3500

    @classmethod
    def from_properties(cls, props) -> "UtrConfig":
        u = cls()
        u.tss_start = props.get_int("/UtrModel/tss_start", u.tss_start)
        u.tss_end = props.get_int("/UtrModel/tss_end", u.tss_end)
        u.tata_start = props.get_int("/UtrModel/tata_start", u.tata_start)
        u.tata_end = props.get_int("/UtrModel/tata_end", u.tata_end)
        u.d_tss_tata_min = props.get_int("/UtrModel/d_tss_tata_min",
                                         u.d_tss_tata_min)
        u.d_tss_tata_max = props.get_int("/UtrModel/d_tss_tata_max",
                                         u.d_tss_tata_max)
        u.d_polyasig_cleavage = props.get_int("/UtrModel/d_polyasig_cleavage",
                                              u.d_polyasig_cleavage)
        u.prob_polya = props.get_float("/UtrModel/prob_polya", u.prob_polya)
        u.max_exon_length = props.get_int("/UtrModel/maxexonlength",
                                          u.max_exon_length)
        u.max3single = props.get_int("/UtrModel/max3singlelength",
                                     u.max3single)
        u.max3term = props.get_int("/UtrModel/max3termlength", u.max3term)
        return u


UTR_CHAIN = (ST.utr5intron, ST.utr3intron, ST.rutr5intron, ST.rutr3intron)
UTR_VAR = (ST.utr5intronvar, ST.utr3intronvar,
           ST.rutr5intronvar, ST.rutr3intronvar)


def _safe_log(x):
    with np.errstate(divide="ignore"):
        return np.log(x)


def prepare_utr(eng, codes: np.ndarray) -> None:
    """Build all UTR tracks on eng (called from GoldEngine.prepare)."""
    up: UtrParams = eng.utr
    uc: UtrConfig = eng.utr_cfg
    cn: Constants = eng.cn
    n = codes.shape[0]
    classes = eng.classes

    # content cumsum tracks (SegProbs semantics: fwd pos<k -> 0.25;
    # rev pos >= n-k -> 0.25)
    eng.cum_utr: Dict = {}
    k1 = up.k + 1
    for c in classes:
        g = up.gc[c]
        for name, table in (("u5i", g.emi_5init), ("u5", g.emi_5),
                            ("u3", g.emi_3)):
            f = T.kmer_lookup_log(codes, k1, table, LOG_QUARTER)
            f[: up.k] = LOG_QUARTER
            r = T.rc_kmer_lookup_log(codes, k1, table, LOG_QUARTER)
            cf = np.zeros(n + 1); cf[1:] = np.cumsum(f)
            cr = np.zeros(n + 1); cr[1:] = np.cumsum(r)
            eng.cum_utr[(c, name, True)] = cf
            eng.cum_utr[(c, name, False)] = cr

    # ---- TSS tracks ----------------------------------------------------
    A, C_, G_, T_ = genetics.A, genetics.C, genetics.G, genetics.T
    tss_up = cn.tss_upwindow_size
    te, ts = uc.tss_end, uc.tss_start
    d_min, d_max = uc.d_tss_tata_min, uc.d_tss_tata_max
    ta_s, ta_e = uc.tata_start, uc.tata_end

    # TATA site detectors (reference findTATA, src/utrmodel.cc:272):
    # fwd pattern t a t a ? a at pos..pos+5; rev: a t a t ? t going down
    def pat6(c0, c1, c2, c3, c5):
        out = np.zeros(n, dtype=bool)
        if n >= 6:
            out[: n - 5] = ((codes[:-5] == c0) & (codes[1:-4] == c1) &
                            (codes[2:-3] == c2) & (codes[3:-2] == c3) &
                            (codes[5:] == c5))
        return out

    tata_f = pat6(T_, A, T_, A, A)
    # reverse: seq[p]==a, p-1==t, p-2==a, p-3==t, p-5==t
    tata_r = np.zeros(n, dtype=bool)
    if n >= 6:
        tata_r[5:] = ((codes[5:] == A) & (codes[4:-1] == T_) &
                      (codes[3:-2] == A) & (codes[2:-3] == T_) &
                      (codes[:-5] == T_))
    # next TATA at or after p (fwd); previous reverse-TATA at or before p
    INF = n + 10
    next_tata = np.full(n + 1, INF, dtype=np.int64)
    for p in range(n - 1, -1, -1):
        next_tata[p] = p if tata_f[p] else next_tata[p + 1]
    prev_rtata = np.full(n + 1, -INF, dtype=np.int64)
    for p in range(n):
        prev_rtata[p + 1] = p if tata_r[p] else prev_rtata[p]
    # prev_rtata[p+1] = largest q <= p with tata_r[q]

    # tssup segment cumsums
    tk1 = up.tssup_k + 1
    eng.tss_plus = {}
    eng.tss_minus = {}
    for c in classes:
        g = up.gc[c]
        tssup_f = T.kmer_lookup_log(codes, tk1, g.tssup, LOG_QUARTER)
        tssup_f[: up.tssup_k] = LOG_QUARTER
        tssup_r = T.rc_kmer_lookup_log(codes, tk1, g.tssup, LOG_QUARTER)
        ctf = np.zeros(n + 1); ctf[1:] = np.cumsum(tssup_f)
        ctr = np.zeros(n + 1); ctr[1:] = np.cumsum(tssup_r)

        def seg_f(l, r):
            l = np.clip(l, 0, n); r = np.clip(r + 1, 0, n)
            return np.where(l >= r, 0.0, ctf[r] - ctf[l])

        def seg_r(l, r):
            l = np.clip(l, 0, n); r = np.clip(r + 1, 0, n)
            return np.where(l >= r, 0.0, ctr[r] - ctr[l])

        m_tss_f = T.motif_score_fwd(codes, g.tss_motif)
        m_tss_r = T.motif_score_rc(codes, g.tss_motif)
        m_tssT_f = T.motif_score_fwd(codes, g.tss_motif_tata)
        m_tssT_r = T.motif_score_rc(codes, g.tss_motif_tata)
        m_tata_f = T.motif_score_fwd(codes, g.tata_motif)
        m_tata_r = T.motif_score_rc(codes, g.tata_motif)

        # ---------------- plus strand -----------------------------------
        left = np.arange(n)
        right = left + tss_up + te - 1
        valid = (right < n) & (left % TTS_SPACING == 0)
        plus = np.full(n, NEG_INF)
        idx = np.flatnonzero(valid)
        if idx.size:
            l = idx
            r = right[idx]
            ws = r - te - d_max + 1
            maxpos = d_max - d_min - 1
            q = next_tata[np.clip(ws, 0, n)]
            has = (ws >= 0) & (q <= ws + maxpos) & (q < n)
            # with TATA
            tpos = q
            mstart = r - te - ts + 1
            withT = np.where(
                has,
                _gather(m_tssT_f, mstart, n)
                + _gather(m_tata_f, tpos - ta_s, n)
                + seg_f(l, tpos - ta_s - 1) + seg_f(tpos + ta_e, mstart - 1),
                NEG_INF)
            noT = (_gather(m_tss_f, mstart, n) + seg_f(l, mstart - 1))
            plus[idx] = np.where(has, withT, noT)
        eng.tss_plus[c] = plus

        # ---------------- minus strand ----------------------------------
        minus = np.full(n, NEG_INF)
        if idx.size:
            l = idx
            r = right[idx]
            # reverse: search start p0 = left + tss_end + d_max - 1, downward
            p0 = l + te + d_max - 1
            maxpos = d_max - d_min - 1
            q = prev_rtata[np.clip(p0, -1, n - 1) + 1]
            has = (q >= p0 - maxpos) & (p0 < n) & (q >= 0)
            tpos = q
            withT = np.where(
                has,
                _gather(m_tssT_r, l, n)
                + _gather(m_tata_r, tpos - ta_e + 1, n)
                + seg_r(l + ta_e + ta_s - 1, tpos - ta_e)
                + seg_r(tpos + ta_s + 1, r),
                NEG_INF)
            noT = (_gather(m_tss_r, l, n) + seg_r(l + te + ts, r))
            minus[idx] = np.where(has, withT, noT)
        eng.tss_minus[c] = minus

    # ---- TTS (polyA) tracks --------------------------------------------
    boxlen = up.aataaa_boxlen
    dpc = uc.d_polyasig_cleavage
    rand_log = -boxlen * np.log(4.0)
    log_polya = float(np.log(uc.prob_polya))
    log_1mpolya = float(np.log(1 - uc.prob_polya)) \
        if uc.prob_polya < 1 else NEG_INF
    box_f = genetics.kmer_ids(codes, boxlen)
    box_r = genetics.rc_kmer_ids(codes, boxlen)
    eng.tts_plus = {}
    eng.tts_minus = {}
    i = np.arange(n)
    with np.errstate(divide="ignore"):
        log_aataaa = np.log(up.aataaa_probs)
    for c in classes:
        g = up.gc[c]
        m_tts_f = T.motif_score_fwd(codes, g.tts_motif)
        m_tts_r = T.motif_score_rc(codes, g.tts_motif)

        def tts_probs(ids, motif_at, ttspos_ok):
            ok = np.zeros(n, dtype=bool)
            ok[: ids.shape[0]] = ids >= 0
            pid = np.zeros(n, dtype=np.int64)
            pid[: ids.shape[0]] = np.where(ids >= 0, ids, 0)
            prob = np.where(ok, log_aataaa[pid] + log_polya, NEG_INF)
            fallback = (i % TTS_SPACING == 0) & (prob == NEG_INF)
            prob = np.where(fallback, log_1mpolya + rand_log, prob)
            prob = np.where(prob > NEG_INF, prob + motif_at, prob)
            return np.where(ttspos_ok, prob, NEG_INF)

        ttspos_f = i + boxlen + dpc - 1
        plus = tts_probs(box_f, _gather(m_tts_f, i + boxlen, n),
                         ttspos_f < n)
        ttspos_r = i - dpc
        minus_ok = (ttspos_r >= 0) & (i + boxlen - 1 < n)
        minus = tts_probs(box_r, _gather(m_tts_r, np.clip(ttspos_r, 0, n - 1),
                                         n), minus_ok)
        # reference bug replicated (src/utrmodel.cc computeTtsProbs): when the
        # minus-strand site is out of range, ttsProbPlus — not Minus — is
        # zeroed, and ttsProbMinus keeps its initial value 0.
        plus = np.where(minus_ok, plus, NEG_INF)
        minus = np.where(minus_ok, minus, NEG_INF)
        eng.tts_plus[c] = plus
        eng.tts_minus[c] = minus

    with np.errstate(divide="ignore"):
        eng.log_len_utr = {kk: np.log(arr)
                           for kk, arr in up.len_dist.items()}
        eng.log_tail5 = np.log(up.tail_len_dist5)
        eng.log_tail3 = np.log(up.tail_len_dist3)


def _gather(arr: np.ndarray, idx, n: int) -> np.ndarray:
    idx = np.asarray(idx)
    ok = (idx >= 0) & (idx < n)
    out = np.where(ok, arr[np.clip(idx, 0, n - 1)], NEG_INF)
    return out


# ---------------------------------------------------------------------------
# DP step
# ---------------------------------------------------------------------------

def get_end_positions(t: ST, j: int, n: int, cn: Constants, uc: UtrConfig,
                      boxlen: int):
    """reference UtrModel::getEndPositions (src/utrmodel.cc:960)."""
    tiw = cn.trans_init_window
    tss_up = cn.tss_upwindow_size
    te = uc.tss_end
    if t == ST.utr5single or t == ST.utr5term:
        return j + 1, j + tiw
    if t in (ST.rutr5single, ST.rutr5init):
        return j - tss_up - te + 1, j - tss_up
    if t in (ST.utr5init, ST.utr5internal, ST.utr3init, ST.utr3internal):
        return j - cn.dss_whole_size + 1, j - cn.dss_end - DSS_MIDDLE
    if t in (ST.rutr5internal, ST.rutr5term, ST.rutr3internal, ST.rutr3term):
        return (j - cn.ass_whole_size - cn.ass_upwindow_size + 1,
                j - cn.ass_upwindow_size - cn.ass_start - ASS_MIDDLE)
    if t in (ST.rutr3single, ST.rutr3init):
        return j + 1, j
    if t in (ST.utr3single, ST.utr3term):
        if j != n - 1:
            return j - uc.d_polyasig_cleavage - boxlen + 1, j
        return n, n - 1
    return j + 1, j


def utr_cands(eng, j: int, c: int, s: int, t: ST, table):
    """Candidates for one UTR state at position j (viterbi/forward)."""
    sg, cn, uc = eng.sg, eng.cn, eng.utr_cfg
    up: UtrParams = eng.utr
    n = eng.n
    lt = eng.log_trans[c]
    codes = eng.codes
    boxlen = up.aataaa_boxlen
    dpc = uc.d_polyasig_cleavage

    if t in UTR_VAR:
        return None   # hints-only states (see module docstring)
    if t in UTR_CHAIN:
        # per-base intron chain state; strand-independent forward
        # patterns; no softmask/intronpart bonus in the reference
        anc = eng.ancestors[s]
        emi = eng.intron_f_nb[c][j] if hasattr(eng, "intron_f_nb") \
            else eng.intron_f[c][j]
        w = table[j - 1][anc] + lt[anc, s] + emi
        return w, anc, np.full(anc.shape[0], j - 1)

    fwd = is_on_f_strand(t)
    sp = eng.splice
    bep, ebx = get_end_positions(t, j, n, cn, uc, boxlen)

    # ---------------- endPart --------------------------------------
    if t in (ST.utr5single, ST.utr5term):
        if (ebx + 3 <= n - 1) and not _is_start(codes, ebx + 1):
            return None
        end_part = 0.0
    elif t in (ST.utr5internal, ST.utr5init, ST.utr3internal,
               ST.utr3init):
        end_part = sp.dss_score[j - cn.dss_whole_size + 1] \
            if j - cn.dss_whole_size + 1 >= 0 else NEG_INF
    elif t in (ST.rutr5internal, ST.rutr5term, ST.rutr3internal,
               ST.rutr3term):
        start = j - cn.ass_upwindow_size - cn.ass_whole_size + 1
        end_part = sp.rass_score[c][start] if start >= 0 else NEG_INF
    elif t in (ST.rutr5single, ST.rutr5init):
        end_part = eng.tss_minus[c][bep] if 0 <= bep < n else NEG_INF
    elif t in (ST.utr3single, ST.utr3term):
        if j == n - 1:
            end_part = 0.0
        elif bep < 0 or bep + boxlen - 1 >= n:
            return None
        else:
            end_part = eng.tts_plus[c][bep]
    else:   # rutr3single, rutr3init: reverse stop codon right after
        if (j + 3 > n - 1) or not _is_rc_stop(eng, j + 1):
            return None
        end_part = 0.0
    if end_part == NEG_INF:
        return None
    if getattr(eng, "hints", None) is not None and ebx < j and \
            t not in (ST.utr3single, ST.utr3term, ST.rutr5single,
                      ST.rutr5init):
        # intronpart/nonexonpart bonus for the intron bases inside the
        # splice windows handled by this exon state (reference
        # UtrModel::endPartEmiProb tail)
        ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
        end_part = end_part + ipbc[j + 1] - ipbc[ebx + 1]

    lo, hi = _pred_range(t, j, n, cn, uc, up)
    if t in (ST.utr5single, ST.utr5init):
        lo = max(lo, -cn.tss_upwindow_size)
    elif t in (ST.rutr3single, ST.rutr3term):
        lo = max(lo, -boxlen - dpc)
    else:
        lo = max(lo, 0)
    if hi < lo:
        return None

    eops = np.arange(hi, lo - 1, -1)
    note = _not_end_part(eng, t, c, eops + 1, bep - 1, ebx)
    valid = note > NEG_INF
    if not valid.any():
        return None
    anc = eng.ancestors[s]
    pred_cols = np.maximum(eops, 0)
    pv = table[pred_cols][:, anc]
    total = pv + lt[anc, s][None, :] + (end_part + note)[:, None]
    total = np.where(valid[:, None], total, NEG_INF)
    na = anc.shape[0]
    return (total.reshape(-1), np.tile(anc, eops.shape[0]),
            np.repeat(eops, na))


def _is_start(codes, pos) -> bool:
    n = codes.shape[0]
    if pos < 0 or pos + 2 >= n:
        return False
    return (codes[pos] == genetics.A and codes[pos + 1] == genetics.T
            and codes[pos + 2] == genetics.G)


def _is_rc_stop(eng, pos) -> bool:
    n = eng.n
    if pos < 0 or pos + 2 >= n:
        return False
    return bool(eng.gcode.rc_stop_at(eng.codes[pos: pos + 3])[0])


def _pred_range(t: ST, j: int, n: int, cn: Constants, uc: UtrConfig,
                up: UtrParams):
    """leftMost/rightMost endOfPred (reference utrmodel.cc:820-940)."""
    mel = uc.max_exon_length
    tiw = cn.trans_init_window
    tss_up = cn.tss_upwindow_size
    te = uc.tss_end
    dws = cn.dss_whole_size
    aws = cn.ass_whole_size
    aup = cn.ass_upwindow_size
    boxlen = up.aataaa_boxlen
    dpc = uc.d_polyasig_cleavage
    if t == ST.utr5single:
        lo = j - (mel - tiw + tss_up)
        hi = min(j - tss_up - te - 1 + tiw + te, j - 1)
    elif t == ST.rutr5single:
        lo = j - (mel - tiw + tss_up)
        hi = min(j - tss_up - 1 + tiw, j - 1)
    elif t in (ST.utr5init, ST.rutr5init):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end + tss_up)
        hi = j - tss_up - te - dws
    elif t in (ST.utr5internal, ST.rutr5internal):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end + aup + cn.ass_start
                  + ASS_MIDDLE)
        hi = j - dws - aup - aws
    elif t in (ST.utr5term, ST.rutr5term):
        lo = j - (mel - tiw + aup + cn.ass_start + ASS_MIDDLE)
        hi = j - aup - aws
        if -aup - aws + tiw + cn.ass_end < 0:
            hi = j - aup - aws + tiw + cn.ass_end
    elif t == ST.utr3single:
        lo = j - uc.max3single
        hi = (j - dpc - boxlen) if j != n - 1 else j - 1
    elif t == ST.rutr3single:
        lo = j - uc.max3single
        hi = j - dpc - boxlen
    elif t in (ST.utr3init, ST.rutr3init):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end)
        hi = j - cn.dss_end - DSS_MIDDLE
    elif t in (ST.utr3internal, ST.rutr3internal):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end + aup + cn.ass_start
                  + ASS_MIDDLE)
        hi = j - dws - aup - aws
    elif t == ST.utr3term:
        lo = j - (uc.max3term + ASS_MIDDLE + cn.ass_start + aup)
        if j != n - 1:
            hi = j - dpc - boxlen - aws - aup
        else:
            hi = j - aws - aup
    elif t == ST.rutr3term:
        lo = j - (uc.max3term + ASS_MIDDLE + cn.ass_start + aup)
        hi = j - dpc - boxlen - aws - aup
    else:
        lo = hi = j - 1
    return lo, hi


def _not_end_part(eng, t: ST, c: int, begins: np.ndarray, end_of_middle: int,
                  ebx: int) -> np.ndarray:
    """Vectorized UtrModel::notEndPartEmiProb over begin positions."""
    cn, uc = eng.cn, eng.utr_cfg
    up: UtrParams = eng.utr
    n = eng.n
    boxlen = up.aataaa_boxlen
    dpc = uc.d_polyasig_cleavage
    tss_up = cn.tss_upwindow_size
    te = uc.tss_end
    tiw = cn.trans_init_window
    LOG2 = float(np.log(2.0))
    LOG4 = float(np.log(4.0))
    ld = eng.log_len_utr

    def seg(name, fwd, l, r):
        cum = eng.cum_utr[(c, name, fwd)]
        l = np.clip(l, 0, n)
        rr = np.clip(r + 1, 0, n)
        return np.where(l >= rr, 0.0, cum[rr] - cum[np.minimum(l, rr)])

    b = begins
    out = np.full(b.shape[0], NEG_INF)

    if t == ST.utr5single:
        bm = b + tss_up + te
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg("u5i", True, bm, end_of_middle),
                          -span * LOG2)
        bob = b + tss_up
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        lenp = ld["5single"][length]
        beginp = np.where(b >= 0, _gather(eng.tss_plus[c], np.clip(b, 0, n - 1), n),
                          (bm - 1) * LOG_QUARTER)
        beginp = np.where(b >= 0, beginp, (bm - 1) * LOG_QUARTER)
        tail_sel = (b + tss_up) == 0
        tail_idx = np.clip(end_of_middle - b + 1 + tiw - tss_up, 0,
                           eng.log_tail5.shape[0] - 1)
        lenp = np.where(tail_sel, eng.log_tail5[tail_idx], lenp)
        out = beginp + middle + lenp
    elif t == ST.utr5init:
        bm = b + tss_up + te
        middle = seg("u5i", True, bm, end_of_middle)
        bob = b + tss_up
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        lenp = ld["5initial"][length]
        beginp = np.where(b >= 0, _gather(eng.tss_plus[c], np.clip(b, 0, n - 1), n),
                          (bm - 1) * LOG_QUARTER)
        tail_sel = (b + tss_up) == 0
        tail_idx = np.clip(ebx - bob + 1, 0, eng.log_tail5.shape[0] - 1)
        lenp = np.where(tail_sel, eng.log_tail5[tail_idx], lenp)
        out = beginp + middle + lenp
    elif t == ST.utr5internal:
        beginp = _gather(eng.splice.ass_score[c], b, n)
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        middle = seg("u5", True, bm, end_of_middle)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["5internal"][length]
    elif t == ST.rutr5internal:
        beginp = _gather(eng.splice.rdss_score, b, n)
        bob = b + cn.dss_end + DSS_MIDDLE
        bm = b + cn.dss_whole_size
        middle = seg("u5", False, bm, end_of_middle)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["5internal"][length]
    elif t == ST.utr5term:
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        beginp = np.where(bob >= n, NEG_INF,
                          _gather(eng.splice.ass_score[c], b, n))
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg("u5", True, bm, end_of_middle),
                          -span * LOG4)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["5terminal"][length]
    elif t == ST.rutr5term:
        bm = b
        bob = b - tiw
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg("u5", False, bm, end_of_middle),
                          -span * LOG4)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = middle + ld["5terminal"][length]
    elif t == ST.rutr5single:
        bm = b
        bob = b - tiw
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg("u5i", False, bm, end_of_middle),
                          -span * LOG2)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = middle + ld["5single"][length]
    elif t == ST.rutr5init:
        beginp = _gather(eng.splice.rdss_score, b, n)
        bob = b + cn.dss_end + DSS_MIDDLE
        bm = b + cn.dss_whole_size
        middle = seg("u5i", False, bm, end_of_middle)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["5initial"][length]
    elif t == ST.utr3single:
        middle = seg("u3", True, b, end_of_middle)
        length = ebx - b + 1
        if ebx != n - 1:
            lenp = ld["3single"][np.clip(length, 0, uc.max3single)]
        else:
            lenp = eng.log_tail3[np.clip(length, 0,
                                         eng.log_tail3.shape[0] - 1)]
        out = middle + lenp
    elif t == ST.rutr3single:
        bm = b + boxlen + dpc
        beginp = np.where(
            b > 0, _gather(eng.tts_minus[c], np.clip(b + dpc, 0, n - 1), n),
            np.where(bm > 0, (bm - 1) * LOG_QUARTER, 0.0))
        length = ebx - b + 1
        lenp = np.where(
            b > 0, ld["3single"][np.clip(length, 0, uc.max3single)],
            eng.log_tail3[np.clip(length, 0, eng.log_tail3.shape[0] - 1)])
        middle = seg("u3", False, bm, end_of_middle)
        out = beginp + middle + lenp
    elif t == ST.utr3init:
        span = end_of_middle - b + 1
        middle = np.where(span >= 0, seg("u3", True, b, end_of_middle),
                          -span * LOG4)
        length = np.clip(ebx - b + 1, 0, uc.max_exon_length)
        out = middle + ld["3initial"][length]
    elif t == ST.rutr3init:
        beginp = _gather(eng.splice.rdss_score, b, n)
        bob = b + cn.dss_end + DSS_MIDDLE
        bm = b + cn.dss_whole_size
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg("u3", False, bm, end_of_middle),
                          -span * LOG4)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["3initial"][length]
    elif t == ST.utr3internal:
        beginp = _gather(eng.splice.ass_score[c], b, n)
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        middle = seg("u3", True, bm, end_of_middle)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["3internal"][length]
    elif t == ST.rutr3internal:
        beginp = _gather(eng.splice.rdss_score, b, n)
        bob = b + cn.dss_end + DSS_MIDDLE
        bm = b + cn.dss_whole_size
        middle = seg("u3", False, bm, end_of_middle)
        length = np.clip(ebx - bob + 1, 0, uc.max_exon_length)
        out = beginp + middle + ld["3internal"][length]
    elif t == ST.utr3term:
        beginp = _gather(eng.splice.ass_score[c], b, n)
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        middle = seg("u3", True, bm, end_of_middle)
        length = ebx - bob + 1
        if ebx != n - 1:
            lenp = ld["3terminal"][np.clip(length, 0, uc.max3term)]
        else:
            lenp = eng.log_tail3[np.clip(length, 0,
                                         eng.log_tail3.shape[0] - 1)]
        out = beginp + middle + lenp
    elif t == ST.rutr3term:
        bm = b + boxlen + dpc
        beginp = np.where(
            b > 0, _gather(eng.tts_minus[c], np.clip(b + dpc, 0, n - 1), n),
            (bm - 1) * LOG_QUARTER)
        middle = seg("u3", False, bm, end_of_middle)
        length = np.clip(ebx - b + 1, 0, uc.max3term)
        out = beginp + middle + ld["3terminal"][length]

    # guard: negative length indices were clipped; forbid length < 1 ...
    # the reference indexes lenDist directly, length 0 has probability 0
    return out
