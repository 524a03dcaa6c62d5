"""Noncoding (nc) model: the host tracks and the candidate enumeration.

Counterpart of `augustus_tpu/engine/gold_nc.py`, numpy host mode only.
`prepare_nc` builds the nc tracks on a GoldEngine (called from
`GoldEngine.prepare_collected`); engine/device.py factorizes them into the
DP tracks that the general Viterbi kernel K2 reads.  `nc_cands` enumerates
one nc state's candidates at one position, for the sampling walk
(`GoldEngine._state_cands`) and for the tests that hold the device tracks
against it.

Implements the 12 noncoding states (single/init/intron/intronvar/internal/
term x both strands) following the reference NcModel
(src/ncmodel.cc: viterbiForwardAndSampling :154, endPartEmiProb :366,
notEndPartEmiProb :447, getEndPositions :702, precomputeTxEndProbs :744,
computeLengthDistributions :133).

The nc model has no trained parameters of its own: content emissions reuse
the intron Markov chain (ncmodel.cc:98 SegProbs(sequence, IntronModel::k)),
internal-exon lengths reuse ExonModel::lenDistInternal (ncmodel.cc:146),
single-exon lengths are a negative binomial (mean 200, dispersion 0.5,
ncmodel.cc:133-148), and transcript boundaries (tss/tts tracks) exist only
near tss/tts/exonpart hints (ncmodel.cc:744-826) -- without hints the nc
exon states are inert.
"""

from __future__ import annotations

import numpy as np

from ..constants import Constants, ASS_MIDDLE, DSS_MIDDLE
from ..model.state_config import ST
from . import tracks as T

NEG_INF = float("-inf")
LOG_QUARTER = float(np.log(0.25))
BOUND_SPACING = 10      # NcModel::boundSpacing (src/ncmodel.cc:32)
MIN_SINGLE_EXON_LEN = 11   # src/ncmodel.cc:138

NC_CHAIN = (ST.ncintron, ST.rncintron)
NC_VAR = (ST.ncintronvar, ST.rncintronvar)
NC_EXON_F = (ST.ncsingle, ST.ncinit, ST.ncinternal, ST.ncterm)
NC_EXON_R = (ST.rncsingle, ST.rncinit, ST.rncinternal, ST.rncterm)


def prepare_nc(eng, codes: np.ndarray) -> None:
    """Build all nc tracks on eng (called from GoldEngine.prepare)."""
    cn: Constants = eng.cn
    n = codes.shape[0]

    # ---- length distributions (ncmodel.cc:133-148) ----------------------
    mean, disp = 200.0, 0.5
    r = 1.0 / disp
    p = mean / (mean + r)
    mel = cn.max_exon_len
    ld = np.zeros(mel + 1)
    ld[0] = (1.0 - p) ** r
    ks = np.arange(1, mel + 1, dtype=np.float64)
    ld[1:] = ld[0] * np.cumprod(p * (ks + r - 1.0) / ks)
    ld[:MIN_SINGLE_EXON_LEN] = 0.0
    with np.errstate(divide="ignore"):
        eng.log_len_ncsingle = np.log(ld)
    # lenDistInternal = ExonModel::lenDistInternal (ncmodel.cc:146)
    eng.log_len_ncinternal = eng.log_len_exon["internal"]

    # ---- tss/tts boundary tracks (precomputeTxEndProbs, :744) -----------
    # linear-space semantics: first containing hint ASSIGNS, further hints
    # MULTIPLY; exonpart boundaries enable grid positions at the malus.
    tss_p = np.full(n + 1, NEG_INF)
    tss_m = np.full(n + 1, NEG_INF)
    tts_p = np.full(n + 1, NEG_INF)
    tts_m = np.full(n + 1, NEG_INF)
    if eng.hints is not None:
        from ..hints.system import distance_faded_bonus
        h = eng.hints

        def fold(track_p, track_m, feats):
            for f in feats:
                for pos in range(max(f.start, 0), min(f.end, n) + 1):
                    fade = distance_faded_bonus(f, pos)
                    if f.strand == "+":
                        track_p[pos] = fade if track_p[pos] == NEG_INF \
                            else track_p[pos] + fade
                    if f.strand == "-":
                        track_m[pos] = fade if track_m[pos] == NEG_INF \
                            else track_m[pos] + fade

        fold(tss_p, tss_m, h.by_type["tss"])
        fold(tts_p, tts_m, h.by_type["tts"])

        lm = eng.log_malus
        tss_malus, tts_malus = lm["tss"], lm["tts"]
        for f in h.by_type["exonpart"]:
            for pos in (f.start, BOUND_SPACING * (f.start // BOUND_SPACING),
                        BOUND_SPACING * (1 + f.start // BOUND_SPACING)):
                if 0 <= pos <= n:
                    if tss_p[pos] == NEG_INF:
                        tss_p[pos] = tss_malus
                    if tts_m[pos] == NEG_INF:
                        tts_m[pos] = tts_malus
            for pos in (f.end, BOUND_SPACING * (f.end // BOUND_SPACING),
                        BOUND_SPACING * (1 + f.end // BOUND_SPACING)):
                if 0 <= pos <= n:
                    if tss_m[pos] == NEG_INF:
                        tss_m[pos] = tss_malus
                    if tts_p[pos] == NEG_INF:
                        tts_p[pos] = tts_malus
    eng.nc_tss_plus, eng.nc_tss_minus = tss_p, tss_m
    eng.nc_tts_plus, eng.nc_tts_minus = tts_p, tts_m

    # dss/ass hint site adjustments with PLAIN bonuses (the nc model uses
    # feature->bonus directly, not the distance-faded exon-model variant;
    # ncmodel.cc:396-418,618-642)
    eng.nc_dss_adj_p = _plain_site_adj(eng, "dss", "+")
    eng.nc_dss_adj_m = _plain_site_adj(eng, "dss", "-")
    eng.nc_ass_adj_p = _plain_site_adj(eng, "ass", "+")
    eng.nc_ass_adj_m = _plain_site_adj(eng, "ass", "-")

    # exonpart zero-coverage cums for the local part malus (exonpartF only,
    # per strand; extrinsicinfo.cc:1805-1818)
    if eng.hints is not None:
        for strand, attr in (("+", "nc_cumcov_ep_plus"),
                             ("-", "nc_cumcov_ep_minus")):
            cov = np.zeros(n, dtype=bool)
            for f in eng.hints.by_type["exonpart"]:
                if f.strand in (strand, "."):
                    cov[max(f.start, 0): f.end + 1] = True
            setattr(eng, attr, np.cumsum(~cov).astype(np.int64))
        eng.log_local_malus_ep = float(
            np.log(eng.ext_cfg.info("exonpart").local_malus))


def _plain_site_adj(eng, hint_type: str, strand: str) -> np.ndarray:
    """adj[pos] = sum(log bonus of containing hints) or the malus if none
    (and a hints file is in effect)."""
    n = eng.n
    if eng.hints is None:
        return np.zeros(n + 1)
    adj = np.full(n + 1, eng.log_malus[hint_type])
    hints = [f for f in eng.hints.by_type[hint_type]
             if f.strand in (strand, ".")]
    for f in hints:
        for p in range(max(f.start, 0), min(f.end, n) + 1):
            if adj[p] == eng.log_malus[hint_type]:
                adj[p] = 0.0
            adj[p] += float(np.log(f.bonus))
    return adj


def get_end_positions(t: ST, j: int, cn: Constants):
    """reference NcModel::getEndPositions (src/ncmodel.cc:702)."""
    if t in (ST.ncinternal, ST.ncinit):
        return j - cn.dss_whole_size + 1, j - cn.dss_end - DSS_MIDDLE
    if t in (ST.rncinternal, ST.rncterm):
        return (j - cn.ass_whole_size - cn.ass_upwindow_size + 1,
                j - cn.ass_upwindow_size - cn.ass_start - ASS_MIDDLE)
    return j + 1, j


def nc_cands(eng, j: int, c: int, s: int, t: ST, table):
    """Candidates for one nc state at position j (viterbi/forward),
    replicating NcModel::viterbiForwardAndSampling (ncmodel.cc:154)."""
    cn = eng.cn
    n = eng.n
    lt = eng.log_trans[c]
    anc = eng.ancestors[s]
    fwd = t in NC_EXON_F or t == ST.ncintron or t == ST.ncintronvar

    if t in NC_CHAIN:
        # per-base intron chain: intron content + intronpart bonus;
        # transitions from a different state (or endOfPred==0) are
        # punished by the intron malus (ncmodel.cc:266-271)
        emi = eng.intron_f[c][j]
        if eng.hints is not None:
            emi = emi + (eng.ipb_plus[j] if fwd else eng.ipb_minus[j])
        w = table[j - 1][anc] + lt[anc, s] + emi
        if eng.hints is not None:
            entry = (anc != s) | (j - 1 == 0)
            w = w + np.where(entry, eng.log_malus["intron"], 0.0)
        return w, anc, np.full(anc.shape[0], j - 1)

    if t in NC_VAR:
        return _nc_intronvar_cands(eng, j, c, s, t, table)

    bep, ebx = get_end_positions(t, j, cn)

    # ---------------- endPartEmiProb (ncmodel.cc:366) --------------------
    sp = eng.splice
    if t in (ST.ncsingle, ST.ncterm):
        end_part = eng.nc_tts_plus[j]
    elif t in (ST.rncsingle, ST.rncinit):
        end_part = eng.nc_tss_minus[j]
    elif t in (ST.ncinit, ST.ncinternal):
        end_part = sp.dss_score[bep] if bep >= 0 else NEG_INF
    else:  # rncterm, rncinternal
        end_part = sp.rass_score[c][bep] if bep >= 0 else NEG_INF
    if end_part == NEG_INF:
        return None
    if eng.hints is not None:
        if t in (ST.ncinternal, ST.ncinit):
            end_part += eng.nc_dss_adj_p[min(ebx + 1, n)]
        if t in (ST.rncinternal, ST.rncterm):
            end_part += eng.nc_ass_adj_m[min(ebx + 1, n)]
        # intronpart bonus inside the trailing splice window; the
        # reference condition omits rncinternal (duplicated ncinternal,
        # ncmodel.cc:423) -- replicated
        if t in (ST.ncinit, ST.ncinternal, ST.rncterm) and ebx < j:
            ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
            end_part += ipbc[j + 1] - ipbc[ebx + 1]

    # ---------------- predecessor range (ncmodel.cc:183-204) -------------
    mel = cn.max_exon_len
    if t in (ST.ncsingle, ST.rncsingle):
        lo, hi = j - mel, j - 1
    elif t in (ST.ncinit, ST.rncinit):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end)
        hi = j - cn.dss_whole_size
    elif t in (ST.ncinternal, ST.rncinternal):
        lo = j - (mel + DSS_MIDDLE + cn.dss_end + cn.ass_upwindow_size
                  + cn.ass_start + ASS_MIDDLE)
        hi = (j - DSS_MIDDLE - cn.dss_end - cn.ass_upwindow_size
              - cn.ass_start - ASS_MIDDLE - 1)
    else:  # ncterm, rncterm
        lo = j - (mel + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE)
        hi = j - cn.ass_upwindow_size - cn.ass_whole_size
    lo = max(lo, 0)

    # hinted-exon narrowing (allowOnlyExonHintedNCExons, ncmodel.cc:221-238)
    strand = "+" if fwd else "-"
    exonparts = []
    if eng.hints is not None:
        exonparts = eng.hints.ovlping(["exon", "exonpart"], lo, ebx, strand)
    min_e = hi + 1
    for f in exonparts:
        if f.start < min_e:
            min_e = f.start
    if min_e > lo:
        lo = min_e
        if lo > hi - 200:
            lo = max(hi - 200, 0)
    if hi < lo:
        return None

    eops = np.arange(hi, lo - 1, -1)
    note = _not_end_part(eng, t, c, eops + 1, bep - 1, ebx, exonparts)
    valid = note > NEG_INF
    if not valid.any():
        return None
    pred_cols = np.maximum(eops, 0)
    pv = table[pred_cols][:, anc]
    total = pv + lt[anc, s][None, :] + (end_part + note)[:, None]
    total = np.where(valid[:, None], total, NEG_INF)
    na = anc.shape[0]
    return (total.reshape(-1), np.tile(anc, eops.shape[0]),
            np.repeat(eops, na))


def _not_end_part(eng, t: ST, c: int, begins: np.ndarray, end_of_middle: int,
                  ebx: int, exonparts) -> np.ndarray:
    """Vectorized NcModel::notEndPartEmiProb (ncmodel.cc:447) over begins."""
    cn = eng.cn
    n = eng.n
    LOG4 = float(np.log(4.0))
    b = begins
    cum = eng.cum_intron_f[c]

    def seg(l, r):
        l = np.clip(l, 0, n)
        rr = np.clip(r + 1, 0, n)
        return np.where(l >= rr, 0.0, cum[rr] - cum[np.minimum(l, rr)])

    def ldist_single(length):
        ok = (length >= 0) & (length <= cn.max_exon_len)
        return np.where(ok, eng.log_len_ncsingle[
            np.clip(length, 0, cn.max_exon_len)], NEG_INF)

    def ldist_internal(length):
        hi = eng.log_len_ncinternal.shape[0] - 1
        ok = (length >= 0) & (length <= hi)
        return np.where(ok, eng.log_len_ncinternal[np.clip(length, 0, hi)],
                        NEG_INF)

    if t == ST.ncsingle:
        bob = b
        begin_p = _track(eng.nc_tss_plus, b, n)
        middle = seg(b, end_of_middle)
        out = begin_p + middle + ldist_single(ebx - bob + 1)
    elif t == ST.ncinit:
        bob = b
        begin_p = _track(eng.nc_tss_plus, b, n)
        middle = seg(b, end_of_middle)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)
    elif t == ST.ncinternal:
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        begin_p = _gather(eng.splice.ass_score[c], b, n)
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        middle = seg(bm, end_of_middle)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)
    elif t == ST.ncterm:
        bob = b + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        begin_p = np.where(bob >= n, NEG_INF,
                           _gather(eng.splice.ass_score[c], b, n))
        bm = b + cn.ass_upwindow_size + cn.ass_whole_size
        span = end_of_middle - bm + 1
        middle = np.where(span >= 0, seg(bm, end_of_middle), -span * LOG4)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)
    elif t == ST.rncsingle:
        bob = b
        begin_p = _track(eng.nc_tts_minus, b, n)
        middle = seg(b, end_of_middle)
        out = begin_p + middle + ldist_single(ebx - bob + 1)
    elif t == ST.rncinternal:
        bob = b + cn.dss_end + DSS_MIDDLE
        begin_p = _gather(eng.splice.rdss_score, b, n)
        bm = b + cn.dss_whole_size
        middle = seg(bm, end_of_middle)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)
    elif t == ST.rncterm:
        bob = b
        begin_p = _track(eng.nc_tts_minus, b, n)
        span = end_of_middle - b + 1
        middle = np.where(span >= 0, seg(b, end_of_middle), -span * LOG4)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)
    else:  # rncinit
        bob = b + cn.dss_end + DSS_MIDDLE
        begin_p = _gather(eng.splice.rdss_score, b, n)
        bm = b + cn.dss_whole_size
        middle = seg(bm, end_of_middle)
        out = begin_p + middle + ldist_internal(ebx - bob + 1)

    if eng.hints is None:
        return out

    # ---------------- extrinsicQuot (ncmodel.cc:575-674) -----------------
    lm = eng.log_malus
    fwd = t in NC_EXON_F
    strand = "+" if fwd else "-"
    nb = b.shape[0]
    quot = np.zeros(nb)
    part_bonus = np.zeros(nb)
    nep = np.zeros(nb, dtype=np.int64)
    num_ep = np.zeros(nb, dtype=np.int64)
    exon_support = np.zeros(nb, dtype=bool)
    for f in exonparts:
        if f.type == "exonpart":
            end_in = (f.end >= bob) & (f.end <= ebx)
            num_ep += end_in
            if f.strand in (strand, "."):
                inside = (f.start >= bob) & (f.end <= ebx)
                part_bonus += np.where(inside, float(np.log(f.bonus)), 0.0)
                nep += inside
        elif f.type == "exon" and f.strand == strand:
            match = (f.start == bob) & (f.end == ebx)
            quot += np.where(match, float(np.log(f.bonus)), 0.0)
            exon_support |= match
    quot += part_bonus
    # local part malus (nep >= 1; ncmodel.cc:599-605)
    lm1 = nep >= 1
    if lm1.any() and eng.log_local_malus_ep != 0.0:
        ccov = eng.nc_cumcov_ep_plus if fwd else eng.nc_cumcov_ep_minus
        e_c = np.clip(ebx, 0, n - 1)
        zc = ccov[e_c] - np.where(bob > 0,
                                  ccov[np.clip(bob - 1, 0, n - 1)], 0)
        lpm = np.where(zc > 0, zc * eng.log_local_malus_ep, 0.0)
        lpm = np.maximum(lpm, -part_bonus)
        quot += np.where(lm1, lpm, 0.0)
    exon_len = ebx - bob + 1
    ln_ep = exon_len - num_ep
    quot += np.where(ln_ep > 0, ln_ep * lm["exonpart"], 0.0)
    quot += np.where(~exon_support, lm["exon"], 0.0)

    # boundary dss/ass hints on the begin side (ncmodel.cc:618-642)
    if t in (ST.rncinternal, ST.rncinit):
        quot += _track(eng.nc_dss_adj_m, bob - 1, n)
    if t in (ST.ncinternal, ST.ncterm):
        quot += _track(eng.nc_ass_adj_p, bob - 1, n)

    # intronpart bonus for the leading splice window (ncmodel.cc:660-674)
    if t in (ST.ncinternal, ST.ncterm, ST.rncinternal, ST.rncinit):
        ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
        l = np.clip(b, 0, n)
        r = np.clip(bob, 0, n)
        quot += np.where(l < r, ipbc[r] - ipbc[np.minimum(l, r)], 0.0)

    return out + quot


def _nc_intronvar_cands(eng, j: int, c: int, s: int, t: ST, table):
    """Variable-length nc intron exactly matching an intron hint
    (ncmodel.cc:286-334)."""
    if eng.hints is None:
        return None
    cn = eng.cn
    n = eng.n
    sp = eng.splice
    fwd = t == ST.ncintronvar
    if fwd:
        ebi = j + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        if not (0 <= ebi < n) or not T.is_possible_ass(sp.ass_ok, ebi):
            return None
    else:
        ebi = j + cn.dss_end + DSS_MIDDLE
        if not (0 <= ebi < n) or not T.is_possible_rdss(sp.rdss_ok, ebi):
            return None
    strand = "+" if fwd else "-"
    hits = [f for f in eng.hints.by_type["intron"]
            if f.end == ebi and (f.strand == strand or f.strand == ".")]
    if not hits:
        return None
    min_len = (cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
               + DSS_MIDDLE + cn.dss_end)
    lt = eng.log_trans[c]
    anc = eng.ancestors[s]
    ws, preds, eops_out = [], [], []
    old_eop = None
    quot = 0.0
    cum = eng.cum_intron_f[c]
    mal = eng.inp.gc[c].mal
    d = eng.inp.d
    log_geo = float(np.log(1.0 - 1.0 / mal)) if mal > 0 else NEG_INF
    log_ld_d = float(eng.log_len_intron[d])
    for f in hits:
        if fwd:
            eop = f.start - 1 + DSS_MIDDLE + cn.dss_end
        else:
            eop = f.start - 1 + cn.ass_upwindow_size + cn.ass_start \
                + ASS_MIDDLE
        if eop < 0 or (f.end - f.start + 1) < min_len:
            continue
        # emiProbUnderModel(eop+1, j): intron content segment and length
        # prob lenDist[d] * (1-1/mal)^(intronLen-d) with the state-relative
        # intron length (ncmodel.cc:545-558)
        bio_len = (j - (eop + 1) + 1) + (cn.dss_end + DSS_MIDDLE if fwd
                                         else cn.ass_upwindow_size
                                         + cn.ass_start + ASS_MIDDLE)
        len_p = log_ld_d + (bio_len - d) * log_geo
        middle = cum[j + 1] - cum[np.clip(eop + 1, 0, n)]
        emi = middle + len_p
        quot = quot + float(np.log(f.bonus)) if eop == old_eop \
            else float(np.log(f.bonus))
        total = table[eop][anc] + lt[anc, s] + emi + quot
        ws.append(total)
        preds.append(anc)
        eops_out.append(np.full(anc.shape[0], eop))
        old_eop = eop
    if not ws:
        return None
    return (np.concatenate(ws), np.concatenate(preds),
            np.concatenate(eops_out))


def _gather(arr: np.ndarray, idx, n: int) -> np.ndarray:
    idx = np.asarray(idx)
    ok = (idx >= 0) & (idx < n)
    return np.where(ok, arr[np.clip(idx, 0, n - 1)], NEG_INF)


def _track(arr: np.ndarray, idx, n: int) -> np.ndarray:
    """Gather from an (n+1,)-sized track with clipping."""
    idx = np.asarray(idx)
    ok = (idx >= 0) & (idx <= n)
    return np.where(ok, arr[np.clip(idx, 0, n)], NEG_INF)
