"""DP tracks: factorized per-state score arrays (counterpart of
augustus_tpu/engine/device.py for the 47-state and the 71-state UTR
architectures, with the hint folds and the sparse exon/CDS hint tables of
softmasked and hinted runs).  `build_tracks` runs on numpy (host route) or,
inside xputil.use_torch, on torch tensors (device route); the sparse
exon/CDS hint tables (`_build_hint_tables`) and the UTR states
(`_build_utr_conv`, chain UTR introns) are host-only: such chunks take the
host route.

Exon emissions factorize as

    score(j, b) = Lane[eop(b)] + G[pool][class, phase, b]
                  + H[pool][class, phase, j] + lenvec[len(j, b)]

for every regime of ExonModel::notEndPartEmiProb (reference
src/exonmodel.cc:1417-1711): the normal piecewise init/content/et case, the
clamped short-exon cases, the tiny-pattern (Pls) case, and the overlapping
begin/end case.  Each regime is one *conv variant*, valid on a static length
range, so the whole exon length loop becomes a handful of banded max-plus
convolutions — dense and maskable.

The per-position "launch lanes" Lane[s, i] = max over ancestors p of
(v[i][p] + log trans[p][s]) are precomputed by the scan as it goes; class-
dependent transitions (into lessD/equalD, out of geometric — reference
IntronModel::updateToLocalGC, src/intronmodel.cc:440-488) are kept out of the
lanes and added at consumption time with the class at the consuming position,
matching the reference's use of the current-class transition matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import genetics
from ..constants import ASS_MIDDLE, DSS_MIDDLE, STOPCODON_LEN
from ..model.state_config import ST, STATE_READING_FRAMES
from .gold import GoldEngine, NEG_INF
from . import tracks as T
from . import xputil as U

F32_NEG = np.float32(-1.0e30)
LOG4 = float(np.log(4.0))
END_PAD = 64     # right padding of windowed arrays (shared with scan.py)

# fast-path cap on the banded exon convolution window: exons longer than this
# are not found by the device engines (the explicit length distribution ends
# at exonLenD=3000 for human; beyond it only a tiny geometric tail remains).
# The gold engine has no cap.  Chosen 0 mod 8 + small margins for tiling.
CONV_CAP = 3040


def _f32(x):
    """Sanitize -inf/nan to F32_NEG.  Kept at full precision (float64 on
    the host, DD-collapsed float32 under device tracing): the final float32
    conversion happens in _finalize_tracks AFTER the baseline rebase, so
    large-magnitude path scores are rounded only once, near zero."""
    return U.sanitize(U.val(x))


def _pre(x):
    """Sanitize WITHOUT collapsing a DD pair: pool arrays that still await
    the baseline rebase (_finalize_tracks) keep their compensation term so
    the large-magnitude cancellation happens before the single f32 round."""
    if U.is_dd(x):
        xp = U.A.xp
        fin = xp.isfinite(x.hi)
        hi = xp.maximum(xp.where(fin, x.hi, np.float64(F32_NEG)),
                        np.float64(F32_NEG))
        lo = xp.where(fin & (x.hi > float(F32_NEG) / 2), x.lo,
                      xp.zeros_like(x.lo))
        return U.DD(hi, lo)
    return U.sanitize(x)


def _c32(x):
    return U.astype(U.sanitize(U.val(x)), np.float32)


def _f32h(x) -> np.ndarray:
    """Host-only sanitize for MODEL-LEVEL constants (never traced): keeps
    them numpy so the static/pack layout machinery stays host data."""
    y = np.array(x, dtype=np.float64)
    np.nan_to_num(y, copy=False, nan=float(F32_NEG), neginf=float(F32_NEG),
                  posinf=float(F32_NEG))
    np.maximum(y, float(F32_NEG), out=y)
    return y


class Pool:
    """Deduplicated array pool; variants reference arrays by index.

    rb tags how the array participates in the baseline rebase
    (_finalize_tracks): ("G", shift) adds base[b - shift] along the last
    (begin-position) axis, ("H",) subtracts base[j], ("cum", ) subtracts
    base[p - 1] (cumulative arrays indexed by position+1), None untouched.
    """

    def __init__(self):
        self.arrays: List[np.ndarray] = []
        self.rb: List[Optional[tuple]] = []
        self._keys: Dict[str, int] = {}

    def add(self, key: str, builder, rb: Optional[tuple] = None) -> int:
        if key not in self._keys:
            self._keys[key] = len(self.arrays)
            self.arrays.append(builder())
            self.rb.append(rb)
        return self._keys[key]


@dataclass
class ConvVariant:
    """One banded max-plus convolution for an exon state.

    len runs over [len_lo, len_hi]; b = j + a_off - len;
    eop = b - bpl - 1.  Score(j, len) =
      lane(len) + G[g_id][c, phi(j), b] + H[h_id][c, phi(j), j]
      + lenvec[len - len_lo]
    where lane(len) is the plain lane for no-frame-check states, or the
    frame-matched lane for internal/terminal-type states.

    vb_lo/vb_hi optionally restrict the ABSOLUTE begin position b (used by
    UTR states whose length distribution switches on the sign of b —
    reference utrmodel.cc notEndPartEmiProb rutr3single branch).
    """
    g_id: int
    h_id: int
    len_lo: int
    len_hi: int
    lenvec: np.ndarray            # (len_hi - len_lo + 1,) f32, len-ascending
    vb_lo: Optional[int] = None
    vb_hi: Optional[int] = None


@dataclass
class ExonConvState:
    state: int
    etype: int
    bpl: int
    a_off: int                    # len = j + a_off - b
    phase_const: int
    phase_sign: int               # phi(j) = (phase_const + phase_sign*j) % 3
    frame_mode: int               # 0 none; 1 fwd (f=(win-len)%3); 2 rev
    win: int
    lane: int                     # first lane id (3 consecutive if frame_mode)
    end_gate: np.ndarray          # (n,) bool
    start_min: np.ndarray         # (n,) int32
    start_max: np.ndarray         # (n,) int32
    variants: List[ConvVariant] = field(default_factory=list)
    # sparse exon-hint metadata (None when inactive; see HintTables)
    hint_strand: Optional[str] = None      # '+' or '-'
    hint_ipo: int = 0             # bob = b - ipo
    hint_bo: int = 0              # ebx = j + bo
    hint_aL: bool = False         # left-anchored exon type
    hint_aR: bool = False         # right-anchored
    hint_exclass: int = 0         # 0 single, 1 internal, 2 term/rinit,
    #                               3 initial/rterm (exon-hint match rule)


@dataclass
class ExonPinnedState:
    state: int
    lane: int
    eop: np.ndarray               # (n,) int32, -1 invalid
    score: np.ndarray             # (C, n) f32 endPart+notEnd, -inf invalid
    # the candidates after the first at positions with several (nc intron
    # hints of one end and several starts), in candidate order: their
    # positions, ends of predecessor and (C, m) scores; None without any
    x_pos: Optional[np.ndarray] = None
    x_eop: Optional[np.ndarray] = None
    x_score: Optional[np.ndarray] = None


@dataclass
class FixedState:
    state: int
    jump: int
    kind: int                     # 0 plain lane; 1 equalD (bare + log(1-psi));
    #                               2 longass (laneA + bare geo lane B)
    lane: int                     # lane id (kind2: laneA; laneB = lane+1)
    emi: np.ndarray               # (C, n) f32


@dataclass
class ChainState:
    state: int
    emi: np.ndarray               # (C, n) f32


@dataclass
class LessDState:
    state: int
    lane: int                     # bare longdss lane
    window: int
    cum_id: int                   # pool id of (C, n+1) intron cumsum
    lenvec: np.ndarray            # (window,) f32 log lenDist by eop offset:
    #                               lenvec[w] for eop = j-1-w (w=0 nearest)
    b_valid: np.ndarray           # (n,) bool indexed by eop
    b_stopflag: np.ndarray        # (n,) int8 indexed by eop
    j_gate: np.ndarray            # (n,) bool
    j_stopsel: np.ndarray         # (n,) int8


@dataclass
class DPTracks:
    n: int
    S: int
    n_classes: int
    n_lanes: int
    gpad: int
    stairs: np.ndarray
    log_trans: np.ndarray          # (C, S, S) f32
    log_init: np.ndarray
    log_term: np.ndarray
    lane_trans: np.ndarray         # (NL, S) f32: lane l = max_p v[p]+lane_trans[l,p]
    lane_target: np.ndarray        # (NL,) int32 target state per lane
    log_psi: np.ndarray            # (C,) f32 log probShortIntron
    log_1mpsi: np.ndarray          # (C,) f32 log (1 - probShortIntron)
    log_geo_ass: np.ndarray        # (C, 3fr+3rev...) actually (C, S) f32:
    #                                log trans[geometric_f -> longass_f] by
    #                                TARGET state index, -inf elsewhere
    base: np.ndarray = None        # rebase potential (see _finalize_tracks)
    pool: List[np.ndarray] = field(default_factory=list)
    chain: List[ChainState] = field(default_factory=list)
    fixed: List[FixedState] = field(default_factory=list)
    lessd: List[LessDState] = field(default_factory=list)
    exon_conv: List[ExonConvState] = field(default_factory=list)
    exon_pinned: List[ExonPinnedState] = field(default_factory=list)
    gold: GoldEngine = None
    hint_tables: Optional[Dict] = None     # strand -> HintTables (sparse)
    hint_lm: Optional[Dict] = None         # log maluses for the sparse path


# ---------------------------------------------------------------------------

def build_tracks(eng: GoldEngine) -> DPTracks:
    sg, cn = eng.sg, eng.cn
    n, S = eng.n, eng.S
    C = len(eng.inp.gc)
    types = sg.state_types
    sp = eng.splice
    dsl = eng.d_state_len
    pool = Pool()

    # ---- lanes ---------------------------------------------------------
    # lane layout: built on the fly; lane_trans rows hold log trans (class-
    # independent) per ancestor, -inf elsewhere; "bare" lanes hold 0 at the
    # single ancestor.
    lane_rows: List[np.ndarray] = []
    lane_tgt: List[int] = []
    base_lt = sg.transitions   # linear, class-independent baseline

    def new_lane(target: int, ancestors: List[int], bare: bool = False) -> int:
        row = np.full(S, NEG_INF)
        for p in ancestors:
            row[p] = 0.0 if bare else (
                np.log(base_lt[p, target]) if base_lt[p, target] > 0 else NEG_INF)
        lane_rows.append(_f32h(row))
        lane_tgt.append(target)
        return len(lane_rows) - 1

    # hint folds (stage 1): per-position separable hint terms are baked
    # into the emission tracks at build time (reference folds them into the
    # DP lazily — igenicmodel.cc:318, intronmodel emiProbUnderModel,
    # exonmodel.cc:1294-1311).  Non-separable exon/CDS hint quotients are
    # handled by the sparse machinery below (see HintCorr).
    xp = U.A.xp
    hints_on = getattr(eng, "hints", None) is not None
    if hints_on:
        eng._device_sparse_hints = any(
            eng.hints.by_type[t] for t in EXON_HINT_KINDS)
        ipb_p, ipb_m = eng.ipb_plus, eng.ipb_minus
        ipc_p, ipc_m = eng.ipb_plus_cum, eng.ipb_minus_cum
        lm = eng.log_malus
    else:
        ipb_p = ipb_m = xp.zeros(n)
        ipc_p = ipc_m = xp.zeros(n + 1)
        lm = {}

    # superwindow back-extent: must cover the longest banded variant.
    # UTR architectures extend it (3' single UTRs up to max3singlelength,
    # reference utrmodel.cc:119 / config /UtrModel/max3singlelength).
    gpad = CONV_CAP + 96
    if any(mc == "utrmodel" for mc in sg.model_class):
        uc = eng.utr_cfg
        need = max(
            uc.max_exon_length + cn.dss_whole_size + cn.ass_upwindow_size
            + cn.ass_whole_size + cn.tss_upwindow_size,
            uc.max3single,
            uc.max3term + cn.ass_whole_size + cn.ass_upwindow_size)
        gpad = max(gpad, ((need + 96 + 127) // 128) * 128)

    if any(mc == "ncmodel" for mc in sg.model_class):
        # the nc exon bands reach back to the sequence start (a hinted
        # exon's begin) or the longest nc exon, whichever is nearer
        gpad = max(gpad, ((_nc_reach(eng) + 96 + 127) // 128) * 128)
    nc_chain: List[tuple] = []

    tr = DPTracks(n=n, S=S, n_classes=C, n_lanes=0, gpad=gpad,
                  stairs=U.astype(eng.stairs, np.int32),
                  log_trans=np.stack([_f32h(lt) for lt in eng.log_trans]),
                  log_init=_f32h(eng.log_init), log_term=_f32h(eng.log_term),
                  lane_trans=None, lane_target=None,
                  log_psi=_f32h([np.log(g.prob_short_intron)
                                 for g in eng.inp.gc]),
                  log_1mpsi=_f32h([np.log(1 - g.prob_short_intron)
                                   for g in eng.inp.gc]),
                  log_geo_ass=None, gold=eng)

    # geometric -> splice-exit class-dependent transition, by TARGET state.
    # Geometric rows are renormalized per GC class (IntronModel::
    # updateToLocalGC); on the forward strand the geometric intron exits
    # into longass, on the reverse strand into rlongdss (mirrored order).
    geo_ass = np.full((C, S), NEG_INF)
    for c in range(C):
        ltc = eng.log_trans[c]
        for s, t in enumerate(types):
            if t in (ST.longass0, ST.longass1, ST.longass2,
                     ST.rlongass0, ST.rlongass1, ST.rlongass2,
                     ST.longdss0, ST.longdss1, ST.longdss2,
                     ST.rlongdss0, ST.rlongdss1, ST.rlongdss2):
                geo = [p for p in range(S) if types[p] in (
                    ST.geometric0, ST.geometric1, ST.geometric2,
                    ST.rgeometric0, ST.rgeometric1, ST.rgeometric2)
                    and sg.transitions[p, s] > 0]
                if geo:
                    geo_ass[c, s] = ltc[geo[0], s]
    tr.log_geo_ass = _f32h(geo_ass)

    # shared lessD/equalD bare lanes by frame-state
    bare_dss_lane: Dict[int, int] = {}   # longdss state idx -> lane

    for s, t in enumerate(types):
        anc = [p for p in range(S) if sg.transitions[p, s] > 0]
        if t == ST.igenic:
            tr.chain.append(ChainState(s, U.stk(
                [_f32(eng.ig_track[c]) for c in range(C)])))
        elif t in (ST.geometric0, ST.geometric1, ST.geometric2,
                   ST.rgeometric0, ST.rgeometric1, ST.rgeometric2):
            # intronpart/nonexonpart hint bonus per base (gold._chain_cands)
            ipb = ipb_p if t in (ST.geometric0, ST.geometric1,
                                 ST.geometric2) else ipb_m
            tr.chain.append(ChainState(s, U.stk(
                [_f32(eng.intron_f[c] + ipb) for c in range(C)])))
        elif t in (ST.longdss0, ST.longdss1, ST.longdss2,
                   ST.rlongdss0, ST.rlongdss1, ST.rlongdss2):
            fwd = t in (ST.longdss0, ST.longdss1, ST.longdss2)
            j = U.arange(n)
            src = sp.dss_score if fwd else sp.rdss_score
            start = j - cn.dss_whole_size + 1
            if fwd:
                gate = T.is_possible_dss_sh(
                    sp.dss_ok, -cn.dss_end - DSS_MIDDLE + 1)
            else:
                gate = T.is_possible_rdss_sh(sp.rdss_ok, -cn.dss_start)
            sel = (start >= 0) & gate
            emi = U.where(sel, U.sg(src, 1 - cn.dss_whole_size, n), NEG_INF)
            if hints_on:
                # intronic sub-range of the dss window
                # (gold._fixed_intron_cands hint branch)
                smc = ipc_p if fwd else ipc_m
                eop = j - cn.dss_whole_size
                if fwd:
                    seg = U.val(U.sg(smc, 1, n) -
                                U.sg(smc, -DSS_MIDDLE - cn.dss_end + 1, n))
                else:
                    seg = U.val(U.sg(smc, 1 - cn.dss_start, n) -
                                U.sg(smc, 1 - cn.dss_whole_size, n))
                emi = xp.where(emi > NEG_INF, emi + seg, emi)
            # reverse-strand longdss states are entered from rgeometric
            # (mirrored intron order) whose row is class-renormalized:
            # split ancestors like longass (kind 2)
            nongeo = [p for p in anc if types[p] not in (
                ST.geometric0, ST.geometric1, ST.geometric2,
                ST.rgeometric0, ST.rgeometric1, ST.rgeometric2)]
            geo = [p for p in anc if p not in nongeo]
            emi_all = xp.broadcast_to(_f32(emi), (C, n))
            if geo:
                laneA = new_lane(s, nongeo)
                laneB = new_lane(s, geo, bare=True)
                assert laneB == laneA + 1
                tr.fixed.append(FixedState(s, cn.dss_whole_size, 2, laneA,
                                           emi_all))
            else:
                lane = new_lane(s, anc)
                tr.fixed.append(FixedState(s, cn.dss_whole_size, 0, lane,
                                           emi_all))
        elif t in (ST.longass0, ST.longass1, ST.longass2,
                   ST.rlongass0, ST.rlongass1, ST.rlongass2):
            fwd = t in (ST.longass0, ST.longass1, ST.longass2)
            jump = cn.ass_whole_size + cn.ass_upwindow_size
            j = U.arange(n)
            start = j - jump + 1
            if fwd:
                gate = T.is_possible_ass_sh(sp.ass_ok, -cn.ass_end)
            else:
                gate = T.is_possible_rass_sh(
                    sp.rass_ok,
                    -cn.ass_upwindow_size - cn.ass_start - ASS_MIDDLE + 1)
            if hints_on:
                smc = ipc_p if fwd else ipc_m
                eop = j - jump
                if fwd:
                    seg = U.val(U.sg(smc, 1 - cn.ass_end, n) -
                                U.sg(smc, 1 - jump, n))
                else:
                    seg = U.val(U.sg(smc, 1, n) -
                                U.sg(smc, 1 - jump + cn.ass_end, n))
            per_c = []
            for c in range(C):
                src = sp.ass_score[c] if fwd else sp.rass_score[c]
                sel = (start >= 0) & gate
                emi = U.where(sel, U.sg(src, 1 - jump, n), NEG_INF)
                if hints_on:
                    emi = xp.where(emi > NEG_INF, emi + seg, emi)
                per_c.append(_f32(emi))
            nongeo = [p for p in anc if types[p] not in (
                ST.geometric0, ST.geometric1, ST.geometric2,
                ST.rgeometric0, ST.rgeometric1, ST.rgeometric2)]
            geo = [p for p in anc if p not in nongeo]
            laneA = new_lane(s, nongeo)
            laneB = new_lane(s, geo, bare=True)
            assert laneB == laneA + 1
            tr.fixed.append(FixedState(s, jump, 2, laneA, U.stk(per_c)))
        elif t in (ST.equalD0, ST.equalD1, ST.equalD2,
                   ST.requalD0, ST.requalD1, ST.requalD2):
            jj = U.arange(n)
            ok_j = jj >= dsl
            hint_seg = 0.0
            if hints_on:
                # gold._fixed_intron_cands: equalD uses the plus cums,
                # requalD the minus cums; + the intron malus
                smc = ipc_p if t in (ST.equalD0, ST.equalD1,
                                     ST.equalD2) else ipc_m
                hint_seg = xp.where(
                    ok_j,
                    U.val(U.sg(smc, 1, n) - U.sg(smc, 1 - dsl, n))
                    + lm["intron"], 0.0)
            per_c = []
            for c in range(C):
                cum = eng.cum_intron_f[c]    # requalD also fwd (quirk)
                seg = U.val(U.sg(cum, 1, n) - U.sg(cum, 1 - dsl, n))
                emi = xp.where(ok_j, seg, NEG_INF)
                if hints_on:
                    emi = xp.where(emi > NEG_INF, emi + hint_seg, emi)
                per_c.append(_f32(emi))
            dss = anc[0]
            if dss not in bare_dss_lane:
                bare_dss_lane[dss] = new_lane(s, [dss], bare=True)
            tr.fixed.append(FixedState(s, dsl, 1, bare_dss_lane[dss],
                                       U.stk(per_c)))
        elif t in (ST.lessD0, ST.lessD1, ST.lessD2,
                   ST.rlessD0, ST.rlessD1, ST.rlessD2):
            dss = anc[0]
            if dss not in bare_dss_lane:
                bare_dss_lane[dss] = new_lane(s, [dss], bare=True)
            tr.lessd.append(_build_lessd(eng, s, t, bare_dss_lane[dss], pool))
        elif t in (ST.rterminal0, ST.rterminal1, ST.rterminal2, ST.rsingleG):
            lane = new_lane(s, anc)
            tr.exon_pinned.append(_build_pinned(eng, s, t, lane, gpad))
        elif sg.model_class[s] == "utrmodel":
            from .gold_utr import UTR_CHAIN, UTR_VAR
            if t in UTR_CHAIN:
                # strand-independent fwd patterns, no intronpart bonus
                # (gold_utr.utr_cands UTR_CHAIN branch)
                tr.chain.append(ChainState(s, np.stack(
                    [_f32(eng.intron_f_nb[c]) for c in range(C)])))
            elif t in UTR_VAR:
                pass   # hints-only intronvar states are inert (gold_utr)
            else:
                lane = new_lane(s, anc)
                tr.exon_conv.append(
                    _build_utr_conv(eng, s, t, lane, pool, gpad))
        elif sg.model_class[s] == "exonmodel":
            fwd = (ST.singleG <= t <= ST.terminal)
            frame_mode = 0
            if t in (ST.internal0, ST.internal1, ST.internal2, ST.terminal):
                frame_mode = 1
            elif t in (ST.rinternal0, ST.rinternal1, ST.rinternal2,
                       ST.rinitial):
                frame_mode = 2
            if frame_mode:
                # 3 lanes, one per predecessor frame 0,1,2
                lanes = []
                for f in range(3):
                    preds = [p for p in anc
                             if STATE_READING_FRAMES[types[p]] == f]
                    lanes.append(new_lane(s, preds))
                lane = lanes[0]
                assert lanes == [lane, lane + 1, lane + 2]
            else:
                lane = new_lane(s, anc)
            tr.exon_conv.append(
                _build_exon_conv(eng, s, t, lane, frame_mode, pool))
        elif sg.model_class[s] == "ncmodel":
            from .gold_nc import NC_CHAIN, NC_VAR
            if t in NC_CHAIN:
                tr.chain.append(ChainState(s, _nc_chain_emi(eng, s, t, anc)))
                nc_chain.append((s, anc))
            elif t in NC_VAR:
                if hints_on:     # the state exists only through intron hints
                    tr.exon_pinned.append(_build_nc_intronvar(
                        eng, s, t, new_lane(s, anc)))
            else:
                tr.exon_conv.append(_build_nc_conv(
                    eng, s, t, new_lane(s, anc), pool, gpad))
        else:
            raise ValueError(f"state {s}: unknown model class "
                             f"{sg.model_class[s]}")

    NL = len(lane_rows)
    tr.n_lanes = NL
    tr.lane_trans = np.stack(lane_rows).astype(np.float32)
    tr.lane_target = np.array(lane_tgt, dtype=np.int32)
    nc_hinted = hints_on and any(mc == "ncmodel" for mc in sg.model_class)
    if hints_on and (getattr(eng, "_device_sparse_hints", False)
                     or nc_hinted):
        tr.hint_tables = {}
        if getattr(eng, "_device_sparse_hints", False):
            tr.hint_tables.update(_hint_tables_cached(eng, gpad))
        if nc_hinted:
            tr.hint_tables.update(_nc_hint_tables(eng, gpad))
        tr.hint_lm = {k: float(lm[k])
                      for k in ("exonpart", "CDSpart", "exon", "CDS")}
        tr.hint_lm["local_cp"] = float(eng.log_local_malus_cp)
        if nc_hinted:
            tr.hint_lm["local_ep"] = float(eng.log_local_malus_ep)
    if hints_on:
        # the nc intron chain pays the intron malus on entry: from every
        # other state (gold_nc.nc_cands, anc != s) in its transition column
        for s, anc in nc_chain:
            for p in anc:
                if p != s:
                    tr.log_trans[:, p, s] += lm["intron"]
    _finalize_tracks(tr, eng, pool)
    return tr


def _finalize_tracks(tr: DPTracks, eng: GoldEngine, pool: Pool) -> None:
    """Baseline rebase + float32 conversion.

    Viterbi scores grow like O(n) while float32 keeps ~7 digits, so at
    megabase scale raw f32 DP values carry O(0.1+) rounding noise and
    near-tie path decisions diverge from the float64 gold engine.  Rebase
    every accumulated quantity by the igenic cumulative log-emission
    base(j) (a per-position potential; argmax-invariant): stored DP values
    become deviations from the igenic path — exactly 0 through intergenic
    stretches — so f32 rounding stays at the ulp of the local deviation.
    base[p <= 0] = 0, so the synch/init boundary region is unaffected.
    """
    xp = U.A.xp
    n = tr.n
    stairs = U.astype(tr.stairs, np.int64)
    ig_all = U.stk([eng.ig_track[c] for c in range(len(eng.inp.gc))])
    igj = U.class_pick(ig_all, stairs)
    # dbase[p] = base[p] - base[p-1] exactly (igj with the p=0 entry zeroed)
    dbase = xp.concatenate([xp.zeros(1, dtype=igj.dtype), igj[1:]]) \
        if n > 1 else xp.zeros(n, dtype=igj.dtype)
    base_dd = U.DD.cumsum_dd(dbase)
    tr.base = U.val(base_dd)

    def base_at(idx):
        bt = base_dd.take(xp.clip(idx, 0, n - 1))
        return bt.where(idx >= 0, 0.0)

    pos = U.arange(n)
    for cs in tr.chain:
        cs.emi = _c32(cs.emi - dbase[None, :])
    for fs in tr.fixed:
        # base[clip(i - jump)] with base[0] == 0: the clip edge IS the
        # idx<0 -> 0 semantics, so a static shift suffices
        adj = U.val(U.sg(base_dd, -fs.jump, n) - base_dd)
        fs.emi = _c32(xp.where(fs.emi > float(F32_NEG) / 2,
                               fs.emi + adj[None, :], fs.emi))
    for ps in tr.exon_pinned:
        adj = U.val(base_at(ps.eop) - base_dd)
        ps.score = _c32(xp.where(ps.score > float(F32_NEG) / 2,
                                 ps.score + adj[None, :], ps.score))
        if ps.x_pos is not None:
            adj = U.val(base_at(ps.x_eop) - base_dd.take(ps.x_pos))
            ps.x_score = _c32(xp.where(ps.x_score > float(F32_NEG) / 2,
                                       ps.x_score + adj[None, :],
                                       ps.x_score))
    for ls in tr.lessd:
        ls.lenvec = np.asarray(ls.lenvec, dtype=np.float32)
    for ecs in tr.exon_conv:
        for var in ecs.variants:
            var.lenvec = np.asarray(var.lenvec, dtype=np.float32)

    out = []
    for arr, rb in zip(pool.arrays, pool.rb):
        a = arr if U.is_dd(arr) else U.sanitize(arr)
        if rb is None:
            out.append(_c32(a))
            continue
        kind = rb[0]
        guard = U.val(a) > float(F32_NEG) / 2 if not U.is_dd(a) \
            else a.hi > float(F32_NEG) / 2
        if kind == "H":
            adj = -base_dd
            a = U.where(guard, a + adj, a)
        elif kind == "G":
            shift = rb[1]
            nb = a.shape[-1]
            if nb == n:                      # plain begin domain [0, n)
                adj = U.sg(base_dd, -shift, n)
            else:                            # extended [-gpad, n+END_PAD)
                adj = base_at(U.arange(nb) - tr.gpad - shift)
            a = U.where(guard, a + adj, a)
        elif kind == "cum":                  # (C, n+1), index p = pos+1
            zero1 = xp.zeros((1,), dtype=U.ftype())
            adj = -U.DD(xp.concatenate([zero1, base_dd.hi]),
                        xp.concatenate([zero1, base_dd.lo]))
            a = a + adj
        out.append(_c32(a))
    tr.pool = out
    tr.log_trans = np.asarray(tr.log_trans, dtype=np.float32)
    tr.log_init = np.asarray(tr.log_init, dtype=np.float32)
    tr.log_term = np.asarray(tr.log_term, dtype=np.float32)
    tr.log_psi = np.asarray(tr.log_psi, dtype=np.float32)
    tr.log_1mpsi = np.asarray(tr.log_1mpsi, dtype=np.float32)
    tr.log_geo_ass = np.asarray(tr.log_geo_ass, dtype=np.float32)


# ---------------------------------------------------------------------------

def _build_lessd(eng: GoldEngine, s: int, t: ST, lane: int,
                 pool: Pool) -> LessDState:
    cn, n = eng.cn, eng.n
    sp = eng.splice
    fwd = t in (ST.lessD0, ST.lessD1, ST.lessD2)
    C = len(eng.inp.gc)
    hints_on = getattr(eng, "hints", None) is not None
    # intronpart bonus cums fold into the content cums; the intron malus
    # folds into the length vector (gold._lessd_cands hint branch)
    ipbc = 0.0
    lm_intron = 0.0
    if hints_on:
        ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
        lm_intron = eng.log_malus["intron"]
    cum_key = ("cum_intron_f" if fwd else "cum_intron_r") + \
        ("_h" if hints_on else "")
    cum_id = pool.add(cum_key, lambda: U.stk(
        [_pre((eng.cum_intron_f[c] if fwd else eng.cum_intron_r[c]) + ipbc)
         for c in range(C)]), rb=("cum",))

    eops = U.arange(n)
    begins = eops + 1
    if fwd:
        c_bbi = 1 - cn.dss_end - DSS_MIDDLE
        bbi = begins - cn.dss_end - DSS_MIDDLE
        b_valid = ~((bbi >= 0) & ~T.is_possible_dss_sh(sp.dss_ok, c_bbi))
    else:
        c_bbi = 1 - cn.ass_outside
        bbi = begins - cn.ass_outside
        b_valid = ~((bbi >= 0) & ~T.is_possible_rass_sh(sp.rass_ok, c_bbi))

    codes = eng.codes
    j = U.arange(n)
    if fwd:
        c_ebi = cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
        ebi = j + c_ebi
        j_gate = ~((ebi - ASS_MIDDLE + 1 < n - 1) &
                   ~T.is_possible_ass_sh(sp.ass_ok, c_ebi))
    else:
        c_ebi = cn.dss_end + DSS_MIDDLE
        ebi = j + c_ebi
        j_gate = ~((ebi - DSS_MIDDLE + 1 < n - 1) &
                   ~T.is_possible_rdss_sh(sp.rdss_ok, c_ebi))
    guard = bbi > 1

    xp = U.A.xp
    c64_ = U.astype(codes, np.int64)

    def ch_sh(c):
        idx = j + c
        ok = (idx >= 0) & (idx < n)
        return xp.where(ok, U.sg(c64_, c, n), np.int64(genetics.N))

    def ch(idx):
        ok = (idx >= 0) & (idx < n)
        return xp.where(ok, U.astype(codes[xp.clip(idx, 0, n - 1)], np.int64),
                        np.int64(genetics.N))

    def i8(x):
        return U.astype(x, np.int8)

    past = ebi >= n - 2
    r1 = xp.where(past, np.int64(genetics.N), ch_sh(c_ebi + 1))
    r2 = xp.where(past, np.int64(genetics.N), ch_sh(c_ebi + 2))
    comp = U.asarr(genetics.COMPLEMENT)
    A, G, Tb, Nb = genetics.A, genetics.G, genetics.T, genetics.N
    b_stop = xp.zeros(n, dtype=np.int8)
    j_sel = xp.zeros(n, dtype=np.int8)
    if t == ST.lessD1:
        l0 = ch_sh(c_bbi - 1)
        b_stop = i8(guard & (l0 == Tb))
        j_sel = i8(((r1 == A) & ((r2 == A) | (r2 == G))) |
                   ((r1 == G) & (r2 == A)))
    elif t == ST.lessD2:
        l0 = ch_sh(c_bbi - 2)
        l1 = ch_sh(c_bbi - 1)
        case_ta = guard & (l0 == Tb) & (l1 == A)
        case_tg = guard & (l0 == Tb) & (l1 == G)
        b_stop = i8(case_ta) | (i8(case_tg) << 1)
        # stop iff (ta & r1 in {a,g}) | (tg & r1==a)
        j_sel = i8((r1 == A) | (r1 == G)) | (i8(r1 == A) << 1)
    elif t == ST.rlessD0:
        l1 = ch_sh(c_bbi - 1)
        l2 = ch_sh(c_bbi - 2)
        c1 = comp[xp.clip(l1, 0, 4)]
        c2 = comp[xp.clip(l2, 0, 4)]
        b_stop = i8(guard & (((c1 == A) & ((c2 == A) | (c2 == G))) |
                             ((c1 == G) & (c2 == A))))
        cr1 = comp[xp.clip(r1, 0, 4)]
        j_sel = i8(cr1 == Tb)
    elif t == ST.rlessD1:
        l1 = ch_sh(c_bbi - 1)
        c2 = comp[xp.clip(l1, 0, 4)]
        cr1 = comp[xp.clip(r1, 0, 4)]
        cr2 = comp[xp.clip(r2, 0, 4)]
        case_ta = (cr2 == Tb) & (cr1 == A)
        case_tg = (cr2 == Tb) & (cr1 == G)
        b_stop = i8(guard & ((c2 == A) | (c2 == G))) | \
            (i8(guard & (c2 == A)) << 1)
        j_sel = i8(case_ta) | (i8(case_tg) << 1)
        # NB: mapping for lessD2/rlessD1: stop iff
        #   (j_sel bit0 & b_stop bit0) ... see kernel `_lessd_stop_mask`

    dsl = eng.d_state_len
    # length = ebi - bbi + 1 = (j - eop) + len_add with
    if fwd:
        len_add = (cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
                   + cn.dss_end + DSS_MIDDLE + 1)
    else:
        len_add = cn.dss_end + DSS_MIDDLE + cn.ass_outside + 1
    # lenvec[w] for eop = j-1-w (so w = j - begins): length = w + len_add
    lv = np.full(dsl, NEG_INF)
    for w in range(dsl):
        ln = w + len_add
        if 0 <= ln <= eng.inp.d:
            lv[w] = eng.log_len_intron[ln] + lm_intron
    return LessDState(state=s, lane=lane, window=dsl, cum_id=cum_id,
                      lenvec=_f32h(lv), b_valid=b_valid, b_stopflag=b_stop,
                      j_gate=j_gate, j_stopsel=j_sel)


# ---------------------------------------------------------------------------

def _pinned_hint_quot(eng, aL: bool, aR: bool, exclass: int,
                      bob, ebx, exon_len, gpad: int, ebx_shift: int = 0):
    """exonpart/CDSpart/exon/CDS quotient for the single-candidate pinned
    states (reverse strand), via the cumulative HintTables decomposition —
    same formulas as scan._hint_quot, evaluated at one begin per j
    (reference exonmodel.cc:1769-1860; host oracle gold._exon_part_quot)."""
    xp = np
    lm = eng.log_malus
    n = eng.n
    if not getattr(eng, "_device_sparse_hints", False):
        # no exon-kind hints: the quotient is the separable malus form
        return (exon_len * (lm["exonpart"] + lm["CDSpart"])
                + lm["exon"] + lm["CDS"])
    ht = _hint_tables_cached(eng, gpad)["-"]
    ebx_sh = ebx_shift            # ebx = i + ebx_shift (static)

    def xr(name, idx, zero_oob_low=True):
        """ht.xrows[name][idx], 0 below 0, saturated above n-1."""
        v = ht.xrows[name]
        g = v[xp.clip(idx, 0, n - 1)]
        return xp.where(idx < 0, 0.0, g) if zero_oob_low else g

    def xre(name):
        """xr at eb = clip(i + ebx_shift): a static shift."""
        return U.sg(ht.xrows[name], ebx_sh, n)

    e_in = ebx <= n - 1          # crossing/exact tables are void past n-1
    eb = xp.clip(ebx, 0, n - 1)
    bm1 = bob - 1

    cov_ep = xp.where(e_in, xre("TX_ep"), 0.0)
    cov_cp = xp.where(e_in, xre("TX_cp"), 0.0)
    covc_ep = xp.where(e_in, xre("TXc_ep"), 0.0)
    covc_cp = xp.where(e_in, xre("TXc_cp"), 0.0)
    for k in range(ht.cross_start.shape[1]):
        sk = ht.cross_start[eb, k]
        wk = ht.cross_w[eb, k]
        fl = ht.cross_flag[eb, k]
        sub = (e_in & (sk >= bob)).astype(wk.dtype)
        cov_ep = cov_ep - xp.where(fl == 1, wk, 0.0) * sub
        covc_ep = covc_ep - xp.where(fl == 1, 1.0, 0.0) * sub
        cov_cp = cov_cp - xp.where(fl == 2, wk, 0.0) * sub
        covc_cp = covc_cp - xp.where(fl == 2, 1.0, 0.0) * sub

    crw_ep = xr("CR_ep", bob)
    inside_ep = xre("BE_ep") - xr("BE_ep", bm1) - crw_ep + cov_ep
    inside_cp = xre("BE_cp") - xr("BE_cp", bm1) - xr("CR_cp", bob) + cov_cp
    ccw_ep = xr("CntCR_ep", bob)
    cin_ep = xre("CntBE_ep") - xr("CntBE_ep", bm1) - ccw_ep + covc_ep
    cin_cp = xre("CntBE_cp") - xr("CntBE_cp", bm1) - \
        xr("CntCR_cp", bob) + covc_cp
    part_bonus = inside_ep + inside_cp
    nep = cin_ep + cin_cp
    if aL:
        part_bonus = part_bonus + 0.5 * (crw_ep - cov_ep)
        nep = nep + (ccw_ep - covc_ep)
    if aR:
        part_bonus = part_bonus + 0.5 * (xre("C2_ep") - cov_ep)
        nep = nep + (xre("CntC2_ep") - covc_ep)
    quot = part_bonus

    sup_ex = xp.zeros(bob.shape)
    sup_cds = xp.zeros(bob.shape)
    for k in range(ht.ex_pos.shape[1]):
        pk = ht.ex_pos[eb, k]
        wk = ht.ex_w[eb, k]
        kd = ht.ex_kind[eb, k]
        cond = (e_in & (kd == 1) & (bob == pk)).astype(wk.dtype)
        quot = quot + wk * cond
        sup_cds = xp.maximum(sup_cds, cond)
        if exclass == 1:
            cond = (e_in & (kd == 2) & (bob == pk)).astype(wk.dtype)
            quot = quot + wk * cond
            sup_ex = xp.maximum(sup_ex, cond)
        elif exclass == 3:
            cond = (e_in & (kd == 3) & (pk < bob) &
                    (pk > -(1 << 29))).astype(wk.dtype)
            quot = quot + 0.5 * wk * cond
            sup_ex = xp.maximum(sup_ex, cond)
    quot = quot + lm["exon"] * (1.0 - sup_ex) + lm["CDS"] * (1.0 - sup_cds)

    d_ep = exon_len - (xre("CntE_ep") - xr("CntE_ep", bm1))
    d_cp = exon_len - (xre("CntE_cp") - xr("CntE_cp", bm1))
    quot = quot + xp.where(d_ep > 0, d_ep * lm["exonpart"], 0.0)
    quot = quot + xp.where(d_cp > 0, d_cp * lm["CDSpart"], 0.0)

    zc = xre("ZC") - xr("ZC", bm1)
    lpm = xp.where(zc > 0, zc * eng.log_local_malus_cp, 0.0)
    lpm = xp.maximum(lpm, -part_bonus)
    quot = quot + xp.where(nep >= 4.5, lpm, 0.0)
    return quot


# ---------------------------------------------------------------------------

def _build_pinned(eng: GoldEngine, s: int, t: ST, lane: int, gpad: int
                  ) -> ExonPinnedState:
    """rterminal*/rsingleG: single begin candidate b = ORFleft+2 per j
    (reference exonmodel.cc:1044).  Vectorized over all j from the dense
    tracks (gold oracle: gold._not_end_part at start_min == start_max,
    gold.py:951-952)."""
    xp = U.A.xp
    cn, n = eng.cn, eng.n
    g = eng.geom[t]
    C = len(eng.inp.gc)
    k = eng.exp.k
    log_nc = float(np.log(cn.prob_n_in_coding))
    L3 = float(np.log(3.0))
    j = U.arange(n)
    hints_on = getattr(eng, "hints", None) is not None

    if t == ST.rsingleG:
        ends = [eng.tis_end_rev[c] for c in range(C)]
    else:
        asspos = j + cn.ass_end + 1
        gate = (j == n - 1) | ((j + cn.ass_end + ASS_MIDDLE < n) &
                               T.is_possible_rass_sh(eng.splice.rass_ok,
                                                     cn.ass_end + 1))
        end = xp.where(gate, 0.0, NEG_INF)
        if hints_on:
            ok = (asspos >= 0) & (asspos < n)
            padj = xp.where(ok, U.sg(eng.ass_site_adj_m, cn.ass_end + 1, n),
                            eng.log_malus["ass"])
            end = xp.where(end > NEG_INF, end + padj, end)
        ends = [end for _ in range(C)]

    # ---- the single begin candidate per j ------------------------------
    end_of_bio = j + g.base_offset
    right = end_of_bio - g.inner_part_end_offset
    frc = int((g.win + g.inner_part_end_offset + 1) % 3)   # frame_of_right
    eon = xp.minimum(end_of_bio, n - 1)
    f_eon = (g.win + 1 + end_of_bio - eon) % 3
    orf_left = T.leftmost_exon_begin(eng.orf, f_eon, eon, False, cn, n)
    b = orf_left + 2
    eop = b - g.begin_part_len - 1
    keep = (right >= 0) & (eop < n)

    # ---- notEndPart, reverse strand ------------------------------------
    bob = b - g.inner_part_offset
    begin = xp.where((bob >= 0) & (bob < n),
                     eng.begin_rstop[xp.clip(bob, 0, n - 1)], NEG_INF)

    # restSeqProb: over / short-pattern / normal regimes
    over_val = (b - right - 1) * LOG4
    lsh = right - b                                     # in [0, k] => short
    short_val = [xp.zeros(n) for _ in range(C)]
    for m in range(0, k + 1):
        rids = eng.rc_kmer_ids_full(m + 1)
        okb = (b >= 0) & (b <= n - (m + 1))
        pid = xp.where(okb, rids[xp.clip(b, 0, max(n - (m + 1), 0))], -1)
        for c in range(C):
            lplsm = U.asarr(eng.log_pls(c, m)[int((frc + m) % 3)])
            v = xp.where(pid >= 0, lplsm[xp.clip(pid, 0, None)],
                         (m + 1) * log_nc)
            short_val[c] = xp.where(lsh == m, v, short_val[c])

    # normal regime (right - b > k)
    begin_initp = right - (k - 1)
    rids_k = eng.rc_kmer_ids_full(k)
    ok_ip = (begin_initp >= 0) & (begin_initp <= n - k)
    pid = xp.where(ok_ip, rids_k[xp.clip(begin_initp, 0, max(n - k, 0))], -1)
    frame_ip = int((frc + k - 1) % 3)
    phi = (frc + right) % 3

    def _gc(cum, ph, idx):
        return cum[(ph, xp.clip(idx, 0, n))]

    def _seg(cum, ph, lo, hi):
        d = _gc(cum, ph, hi + 1) - _gc(cum, ph, lo)
        return U.where(lo > hi, 0.0, U.val(d) if U.is_dd(d) else d)

    initL = cn.init_coding_len
    begin_init = xp.maximum(begin_initp - initL, b)

    # length distribution + hint quotient (class-independent)
    exon_len = end_of_bio - bob + 1
    le = xp.clip(exon_len, 0, cn.max_exon_len)
    if t == ST.rsingleG:
        lend = U.asarr(eng.log_len_exon["single"])
        lp = xp.where((exon_len >= 1) & (exon_len % 3 == 0),
                      L3 + lend[le], NEG_INF)
    else:
        lend = U.asarr(eng.log_len_exon["terminal"])
        lp = xp.where((exon_len >= 1) & ((2 - exon_len) % 3 == g.win),
                      L3 + lend[le], NEG_INF)
    quot = 0.0
    if hints_on:
        quot = _pinned_hint_quot(eng, True, t == ST.rsingleG,
                                 0 if t == ST.rsingleG else 3, bob,
                                 end_of_bio, exon_len, gpad,
                                 ebx_shift=g.base_offset)

    score_c = []
    for c in range(C):
        lplsk = U.asarr(eng.log_pls(c, k - 1)[frame_ip])
        initpat = xp.where(pid >= 0, lplsk[xp.clip(pid, 0, None)],
                           k * log_nc)
        cum_emi = eng.cum_exon[(c, "emi", False)]
        if t == ST.rsingleG:
            cum_init = eng.cum_exon[(c, "init", False)]
            seg = _seg(cum_init, phi, begin_init, begin_initp - 1) + \
                _seg(cum_emi, phi, b, begin_init - 1)
        else:   # rterminal*
            seg = _seg(cum_emi, phi, b, begin_initp - 1)
        normal_val = initpat + seg
        rest = xp.where(b > right, over_val,
                        xp.where(lsh <= k, short_val[c], normal_val))
        note = begin + rest + lp + quot
        v = xp.where((note > NEG_INF) & (ends[c] > NEG_INF) & keep,
                     note + ends[c], NEG_INF)
        score_c.append(v)
    score = U.stk(score_c)
    live = score_c[0] > NEG_INF
    for sc in score_c[1:]:
        live = live | (sc > NEG_INF)
    eop_arr = U.astype(xp.where(live, eop, -1), np.int32)
    return ExonPinnedState(state=s, lane=lane, eop=eop_arr,
                           score=_f32(score))


# ---------------------------------------------------------------------------

def _build_exon_conv(eng: GoldEngine, s: int, t: ST, lane: int,
                     frame_mode: int, pool: Pool) -> ExonConvState:
    """Build conv variants for one exon state.

    G pool arrays: (C, 3, n) phase-indexed over b (or (C, 1, n) when
    phase-free); H pool arrays: (C, n) — already evaluated at the phase
    phi(j), which is a pure function of j for a fixed state.
    """
    cn, n = eng.cn, eng.n
    g = eng.geom[t]
    k = eng.exp.k
    C = len(eng.inp.gc)
    sp = eng.splice
    codes = eng.codes
    log_nc = float(np.log(cn.prob_n_in_coding))
    fwd = g.forward
    initL, etL = cn.init_coding_len, cn.et_coding_len

    ro = g.base_offset - g.inner_part_end_offset           # right = j + ro
    a_off = g.base_offset + g.inner_part_offset + 1        # len = j+a_off-b
    if fwd:
        frc = (g.win - 1 - g.inner_part_end_offset) % 3
        phase_const, phase_sign = (frc - ro) % 3, -1       # phi=(pc - j)%3
    else:
        frc = (g.win + 1 + g.inner_part_end_offset) % 3
        phase_const, phase_sign = (frc + ro) % 3, +1       # phi=(pc + j)%3

    m2len = g.inner_part_offset + g.inner_part_end_offset + 1

    b = U.arange(n)
    j = U.arange(n)
    right = j + ro
    phi_j = (phase_const + phase_sign * j) % 3             # (n,)

    hints_on = getattr(eng, "hints", None) is not None
    lm = eng.log_malus if hints_on else {}
    xp = U.A.xp

    def _site_adj(track, shift, oob):
        """track[i+shift] where in range else oob (site hint fades/malus);
        STATIC integer shift -> slice+pad instead of a gather."""
        pos = j + shift
        ok = (pos >= 0) & (pos < n)
        return xp.where(ok, U.sg(track, shift, n), oob)

    cums = {name: [eng.cum_exon[(c, name, fwd)] for c in range(C)]
            for name in ("emi", "init", "et")}

    def catb(name, shift):
        """(C, 3, n): cum[name][c][:, clip(i+shift, 0, n)] — for G
        (b-indexed); STATIC shift -> slice+pad."""
        return U.stk([U.sg(cums[name][c], shift, n) for c in range(C)])

    def catj(name, shift):
        """(C, n): cum at the j-phase — for H; the phase pick is a
        3-way select over shifted rows (not a 2D gather)."""
        out = []
        for c in range(C):
            rows = U.sg(cums[name][c], shift, n)   # (3, n) or DD
            r = rows[0]
            for f in (1, 2):
                r = U.where(phi_j == f, rows[f], r)
            out.append(r)
        return U.stk(out)

    # ---------------- begin-part track over b ---------------------------
    bob = b - g.inner_part_offset
    begin_list = []
    for c in range(C):
        if t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2):
            bt = xp.where((bob >= 0) & (bob < n),
                          U.sg(eng.tis_begin_fwd[c],
                               -g.inner_part_offset, n), NEG_INF)
        elif t in (ST.terminal, ST.internal0, ST.internal1, ST.internal2):
            shortcut = (bob < 0) | ((bob - ASS_MIDDLE >= 0) &
                                    ~T.is_possible_ass_sh(
                                        sp.ass_ok,
                                        -g.inner_part_offset - 1))
            bt = xp.where(b > 0, xp.where(shortcut, NEG_INF, 0.0),
                          xp.where(b == 0, 0.0, NEG_INF))
            if hints_on:
                padj = _site_adj(eng.ass_site_adj_p,
                                 -g.inner_part_offset - 1, lm["ass"])
                bt = xp.where((b > 0) & (bt > NEG_INF), bt + padj, bt)
        else:   # rinitial, rinternal*
            blocked = (bob < 0) | ((bob - DSS_MIDDLE > 0) &
                                   ~T.is_possible_rdss_sh(
                                       sp.rdss_ok,
                                       -g.inner_part_offset - 1))
            bt = xp.where(b == 0, 0.0, xp.where(blocked, NEG_INF, 0.0))
            if hints_on:
                # malus only when beginOfBioExon > 0 (exonmodel.cc:1534)
                padj = _site_adj(eng.dss_site_adj_m,
                                 -g.inner_part_offset - 1, 0.0)
                bt = xp.where((b != 0) & (bt > NEG_INF), bt + padj, bt)
        begin_list.append(bt)
    begin_arr = U.stk(begin_list)                          # (C, n)
    begin_key = {
        ST.singleG: "tis", ST.initial0: "tis", ST.initial1: "tis",
        ST.initial2: "tis", ST.terminal: "ass", ST.internal0: "ass",
        ST.internal1: "ass", ST.internal2: "ass", ST.rinitial: "rdss",
        ST.rinternal0: "rdss", ST.rinternal1: "rdss", ST.rinternal2: "rdss",
    }[t]

    # ---------------- end gate / endPart over j -------------------------
    if t in (ST.singleG, ST.terminal):
        end_part = U.stk([eng.end_stop_fwd for _ in range(C)])
    elif t == ST.rinitial:
        end_part = U.stk([eng.tis_end_rev[c] for c in range(C)])
    elif t in (ST.initial0, ST.initial1, ST.initial2,
               ST.internal0, ST.internal1, ST.internal2):
        dsspos = j + cn.dss_start + 1
        mid = (j < n - 1) & ~(((dsspos + DSS_MIDDLE - 1 < n) &
                               ~T.is_possible_dss_sh(sp.dss_ok,
                                                     cn.dss_start + 1)) |
                              (j + cn.dss_start >= n))
        # vectorized leftmostExonBegin with the RAW frame value win-1
        # (may be -1 for win==0: then pos = base+1 — the (frame==0)|(==1)
        # branch of T.leftmost_exon_begin handles exactly that mapping)
        lmb = T.leftmost_exon_begin(
            eng.orf, g.win - 1, j + cn.dss_start, True, cn, n)
        gate = xp.where((j == n - 1) | (mid & (lmb < j)), 0.0, NEG_INF)
        if hints_on:
            padj = _site_adj(eng.dss_site_adj_p, cn.dss_start + 1,
                             lm["dss"])
            gate = xp.where(gate > NEG_INF, gate + padj, gate)
        end_part = U.stk([gate for _ in range(C)])
    else:   # rinternal*
        asspos = j + cn.ass_end + 1
        mid = (j < n - 1) & (j + cn.ass_end + ASS_MIDDLE < n) & \
            T.is_possible_rass_sh(sp.rass_ok, cn.ass_end + 1)
        gate = xp.where((j == n - 1) | mid, 0.0, NEG_INF)
        if hints_on:
            padj = _site_adj(eng.ass_site_adj_m, cn.ass_end + 1,
                             lm["ass"])
            gate = xp.where(gate > NEG_INF, gate + padj, gate)
        end_part = U.stk([gate for _ in range(C)])
    # separable part of the exonpart/CDS hint quotient
    # (gold._exon_part_quot with no exonpart/CDSpart/exon/CDS hints):
    # exon_len*(malus_ep + malus_cp) + malus_exon + malus_CDS.  The linear
    # term folds into the length vectors, the constants into endPart.
    # With such hints present the sparse HintCorr machinery replaces this.
    lm_lin = 0.0
    if hints_on and not getattr(eng, "_device_sparse_hints", False):
        end_part = xp.where(end_part > NEG_INF,
                            end_part + lm["exon"] + lm["CDS"], end_part)
        lm_lin = lm["exonpart"] + lm["CDSpart"]

    end_gate = xp.any(end_part > NEG_INF, axis=0)

    # ---------------- length distribution -------------------------------
    kind = {ST.singleG: "single", ST.initial0: "initial",
            ST.initial1: "initial", ST.initial2: "initial",
            ST.rinitial: "initial", ST.terminal: "terminal"}.get(t, "internal")
    base_ld = eng.log_len_exon[kind] + np.log(3.0)
    maxlen = base_ld.shape[0] - 1
    ld = base_ld.copy()
    l = np.arange(maxlen + 1)
    if t == ST.singleG:
        ld[(l % 3) != 0] = NEG_INF
    elif t in (ST.initial0, ST.initial1, ST.initial2):
        ld[((l % 3) != g.win) | (l <= 2)] = NEG_INF
    elif t == ST.rinitial:
        ld[l <= 2] = NEG_INF
    ld[0] = NEG_INF

    variants: List[ConvVariant] = []
    state_tag = str(int(t))

    def add_variant(gid, hid, m_lo, m_hi):
        len_lo, len_hi = m_lo + m2len, m_hi + m2len
        # b <= startMax <= j + bpl implies len >= a_off - bpl: shorter
        # lengths can never be reached (reference clamps startMax,
        # exonmodel.cc:1052)
        len_lo = max(len_lo, 1, a_off - g.begin_part_len)
        len_hi = min(len_hi, maxlen, CONV_CAP)
        if len_lo > len_hi:
            return
        lv = ld[len_lo: len_hi + 1] + \
            np.arange(len_lo, len_hi + 1) * lm_lin
        variants.append(ConvVariant(g_id=gid, h_id=hid, len_lo=len_lo,
                                    len_hi=len_hi, lenvec=_f32h(lv)))

    def initpat_fwd_c(c):
        ids = eng.kmer_ids_full(k)
        m_ids = ids.shape[0]
        sel = U.arange(m_ids)
        ok = ids >= 0
        lpls = U.asarr(eng.log_pls(c, k - 1))   # log gathered, not recomputed
        idc = xp.where(ok, ids, 0)
        by_f = [lpls[f][idc] for f in range(3)]  # small-table gathers
        tail = xp.full((n - m_ids,), k * log_nc, dtype=U.ftype())
        rows = []
        for phi in range(3):
            frame_ip = (phi + sel + k - 1) % 3
            v = by_f[0]
            for f in (1, 2):
                v = xp.where(frame_ip == f, by_f[f], v)
            v = xp.where(ok, v, k * log_nc)
            rows.append(xp.concatenate([v, tail]))
        return xp.stack(rows)

    def initpat_rev_c(c):
        rids = eng.rc_kmer_ids_full(k)
        m_ids = rids.shape[0]
        sel = U.arange(m_ids)
        ok = rids >= 0
        lpls = U.asarr(eng.log_pls(c, k - 1))
        idc = xp.where(ok, rids, 0)
        by_f = [lpls[f][idc] for f in range(3)]
        tail = xp.full((n - m_ids,), k * log_nc, dtype=U.ftype())
        rows = []
        for phi in range(3):
            frame_ip = (phi - sel) % 3
            v = by_f[0]
            for f in (1, 2):
                v = xp.where(frame_ip == f, by_f[f], v)
            v = xp.where(ok, v, k * log_nc)
            rows.append(xp.concatenate([v, tail]))
        return xp.stack(rows)

    def micro_track(m):
        """(C, n) log Pls[m] value of the pattern [right-m, right] at the
        state's constant frame(+m on reverse), plus endPart."""
        per_c = []
        if fwd:
            ids = eng.kmer_ids_full(m + 1)
            frame = frc
        else:
            ids = eng.rc_kmer_ids_full(m + 1)
            frame = (frc + m) % 3
        ok = ids >= 0
        idc = xp.where(ok, ids, 0)
        pstart = right - m
        okr = (pstart >= 0) & (pstart <= n - (m + 1))
        for c in range(C):
            lplsm = U.asarr(eng.log_pls(c, m)[frame])
            v2 = xp.where(ok, lplsm[idc], (m + 1) * log_nc)
            v2f = xp.concatenate(
                [v2, xp.full((n - v2.shape[0],), (m + 1) * log_nc,
                             dtype=U.ftype())]) if v2.shape[0] < n else v2
            track = xp.where(okr, U.sg(v2f, ro - m, n), NEG_INF)
            per_c.append(track + U.val(end_part)[c])
        return _f32(U.stk(per_c))

    rbG = ("G", g.begin_part_len + 1)
    lin4 = U.LinRamp(LOG4, n)
    gid_begin = pool.add(f"G_begin_{begin_key}",
                         lambda: _pre(begin_arr[:, None, :]), rb=rbG)
    gid_over = pool.add(f"G_over_{begin_key}", lambda: _pre(
        lin4.at(b) + U.asarr(begin_arr)[:, None, :]), rb=rbG)
    hid_over = pool.add(f"H_over_{ro}_{state_tag}", lambda: _pre(
        (-lin4.at(right + 1)) + U.val(end_part)), rb=("H",))

    if fwd:
        initpat_id = pool.add("initpat_fwd", lambda: _f32(
            U.stk([initpat_fwd_c(c) for c in range(C)])))
        initpat = pool.arrays[initpat_id]   # (C,3,n)

        if t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2):
            gid_main = pool.add(f"G_fwd_ini_{begin_key}", lambda: _pre(
                initpat + catb("init", k + initL)
                - catb("init", k) - catb("emi", k + initL)
                + begin_arr[:, None, :]), rb=rbG)
            gid_ti = pool.add(f"G_fwd_initrunc_{begin_key}", lambda: _pre(
                initpat - catb("init", k)
                + begin_arr[:, None, :]), rb=rbG)
        else:
            gid_main = pool.add(f"G_fwd_int_{begin_key}", lambda: _pre(
                initpat - catb("emi", k)
                + begin_arr[:, None, :]), rb=rbG)
            gid_ti = None

        def h_et():
            bot_sh = ro - etL + 1
            return _pre(catj("emi", bot_sh) + catj("et", ro + 1)
                        - catj("et", bot_sh) + end_part)

        def h_e():
            return _pre(catj("emi", ro + 1) + end_part)

        def h_i():
            return _pre(catj("init", ro + 1) + end_part)

        if t in (ST.initial0, ST.initial1, ST.initial2):
            hid_main = pool.add(f"H_fwd_et_{ro}_{state_tag}", h_et, rb=("H",))
            hid_noet = pool.add(f"H_fwd_e_{ro}_{state_tag}", h_e, rb=("H",))
            hid_initr = pool.add(f"H_fwd_i_{ro}_{state_tag}", h_i, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_ti, hid_initr, k + 1, k + initL - 2)
            add_variant(gid_main, hid_noet, k + initL - 1,
                        k + initL + etL - 2)
            add_variant(gid_main, hid_main, k + initL + etL - 1,
                        maxlen - m2len)
        elif t == ST.singleG:
            hid_e = pool.add(f"H_fwd_e_{ro}_{state_tag}", h_e, rb=("H",))
            hid_i = pool.add(f"H_fwd_i_{ro}_{state_tag}", h_i, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_ti, hid_i, k + 1, k + initL - 2)
            add_variant(gid_main, hid_e, k + initL - 1, maxlen - m2len)
        elif t in (ST.internal0, ST.internal1, ST.internal2):
            hid_main = pool.add(f"H_fwd_et_{ro}_{state_tag}", h_et, rb=("H",))
            hid_noet = pool.add(f"H_fwd_e_{ro}_{state_tag}", h_e, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_main, hid_noet, k + 1, k + etL - 2)
            add_variant(gid_main, hid_main, k + etL - 1, maxlen - m2len)
        else:   # terminal
            hid_e = pool.add(f"H_fwd_e_{ro}_{state_tag}", h_e, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_main, hid_e, k + 1, maxlen - m2len)
    else:
        initpat_rev_id = pool.add("initpat_rev", lambda: _f32(
            U.stk([initpat_rev_c(c) for c in range(C)])))
        initpat_rev = pool.arrays[initpat_rev_id]

        binp = right - (k - 1)

        def ipb():
            ok = (binp >= 0) & (binp < n)
            sh = ro - (k - 1)
            out = []
            for c in range(C):
                rows = U.sg(initpat_rev[c], sh, n)     # (3, n)
                r = rows[0]
                for f in (1, 2):
                    r = xp.where(phi_j == f, rows[f], r)
                out.append(xp.where(ok, r, NEG_INF))
            return U.stk(out)

        gid_et = pool.add(f"G_rev_et_{begin_key}", lambda: _pre(
            catb("et", etL) - catb("et", 0) - catb("emi", etL)
            + begin_arr[:, None, :]), rb=rbG)
        gid_plain = pool.add(f"G_rev_plain_{begin_key}", lambda: _pre(
            -catb("emi", 0) + begin_arr[:, None, :]), rb=rbG)
        gid_i2 = pool.add(f"G_rev_init2_{begin_key}", lambda: _pre(
            -catb("init", 0) + begin_arr[:, None, :]), rb=rbG)

        if t == ST.rinitial:
            def h_rini():
                b_sh = ro - (k - 1)
                bi_sh = b_sh - initL
                return _pre(ipb() + catj("init", b_sh) - catj("init", bi_sh)
                            + catj("emi", bi_sh) + end_part)

            def h_rinit2():
                return _pre(ipb() + catj("init", ro - (k - 1)) + end_part)

            hid_main = pool.add(f"H_rini_{ro}_{state_tag}", h_rini, rb=("H",))
            hid_i2 = pool.add(f"H_rinit2_{ro}_{state_tag}", h_rinit2, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_i2, hid_i2, k + 1, k + initL - 2)
            add_variant(gid_plain, hid_main, k + initL - 1,
                        k + initL + etL - 2)
            add_variant(gid_et, hid_main, k + initL + etL - 1,
                        maxlen - m2len)
        else:   # rinternal*
            def h_rint():
                return _pre(ipb() + catj("emi", ro - (k - 1)) + end_part)

            hid_main = pool.add(f"H_rint_{ro}_{state_tag}", h_rint, rb=("H",))
            add_variant(gid_over, hid_over, -m2len + 1, -1)
            add_variant(gid_plain, hid_main, k + 1, k + etL - 2)
            add_variant(gid_et, hid_main, k + etL - 1, maxlen - m2len)

    for m in range(0, k + 1):
        strand_tag = "f" if fwd else "r"
        frame_tag = frc if fwd else (frc + m) % 3
        hid_m = pool.add(f"H_micro_{strand_tag}_{frame_tag}_{m}_{ro}_"
                         f"{state_tag}", lambda m=m: micro_track(m),
                         rb=("H",))
        add_variant(gid_begin, hid_m, m, m)

    variants.sort(key=lambda v: v.len_lo)

    # ---------------- start bounds --------------------------------------
    eon = right + g.inner_part_end_offset
    if t in (ST.terminal, ST.singleG):
        eon = eon - STOPCODON_LEN
    eon = xp.minimum(eon, n - 1)
    if fwd:
        f_eon = (g.win - 1 - (j + g.base_offset) + eon) % 3
    else:
        f_eon = (g.win + 1 + (j + g.base_offset) - eon) % 3
    orf_left = U.astype(T.leftmost_exon_begin(eng.orf, f_eon, eon, fwd, cn,
                                              n), np.int64)
    smax = (j + g.base_offset) + g.inner_part_offset - cn.min_exon_length + 1
    smax = xp.minimum(smax, j + g.begin_part_len)
    smin = xp.where(orf_left <= 0, 0, orf_left + g.inner_part_offset)

    ecs = ExonConvState(
        state=s, etype=int(t), bpl=g.begin_part_len, a_off=a_off,
        phase_const=phase_const, phase_sign=phase_sign,
        frame_mode=frame_mode, win=g.win, lane=lane,
        end_gate=end_gate, start_min=U.astype(smin, np.int32),
        start_max=U.astype(smax, np.int32), variants=variants)
    if hints_on and getattr(eng, "_device_sparse_hints", False):
        ecs.hint_strand = "+" if fwd else "-"
        ecs.hint_ipo = g.inner_part_offset
        ecs.hint_bo = g.base_offset
        ecs.hint_aL = t in (ST.singleG, ST.initial0, ST.initial1,
                            ST.initial2)
        ecs.hint_aR = t in (ST.singleG, ST.terminal, ST.rinitial)
        if t in (ST.internal0, ST.internal1, ST.internal2,
                 ST.rinternal0, ST.rinternal1, ST.rinternal2):
            ecs.hint_exclass = 1
        elif t in (ST.terminal, ST.rinitial):
            ecs.hint_exclass = 2
        elif t == ST.singleG:
            ecs.hint_exclass = 0
        else:   # initial0-2 (rterminal/rsingleG are pinned, not convs)
            ecs.hint_exclass = 3
    return ecs


def _build_utr_conv(eng, s, t, lane: int, pool: Pool, gpad: int):
    """One UTR exon state as banded max-plus convolution variants.

    Gold oracle: gold_utr.utr_cands/_not_end_part (reference
    src/utrmodel.cc:796-1130).  With a_off = 1, len := j - b + 1.  All
    begin-side terms (TSS/TTS/splice begin scores, -cum at the middle start
    bm(b), begin-bound clamps) are functions of b alone and are encoded in
    extended-domain G arrays covering b in [-gpad, n+END_PAD); all end-side
    terms (endPart, +cum at end-of-middle, intronpart folds) are functions
    of j (H arrays); the length distribution and the short-exon span
    fallbacks (-span*log2/log4, utrmodel.cc notEndPartEmiProb) fold into
    per-variant length vectors, split at the span-sign boundary.
    """
    from ..model.state_config import is_on_f_strand
    cn, n = eng.cn, eng.n
    uc = eng.utr_cfg
    up = eng.utr
    C = len(eng.inp.gc)
    sp = eng.splice
    codes = eng.codes
    fwd = is_on_f_strand(t)
    hints_on = getattr(eng, "hints", None) is not None

    tiw = cn.trans_init_window
    tss_up = cn.tss_upwindow_size
    te = uc.tss_end
    dws = cn.dss_whole_size
    aws = cn.ass_whole_size
    aup = cn.ass_upwindow_size
    dend, dstart = cn.dss_end, cn.dss_start
    aend, astart = cn.ass_end, cn.ass_start
    boxlen = up.aataaa_boxlen
    dpc = uc.d_polyasig_cleavage
    mel = uc.max_exon_length
    LOG2 = float(np.log(2.0))
    LQ = float(np.log(0.25))
    ld = eng.log_len_utr
    jj = np.arange(n)
    be = np.arange(-gpad, n + END_PAD)      # extended begin domain
    n_ext = be.shape[0]

    # ---- len band [Kh, Kl] (gold_utr._pred_range, eop in [j-Kl, j-Kh]) ---
    if t in (ST.utr5single, ST.rutr5single):
        Kl = mel - tiw + tss_up
        Kh = max(tss_up + 1 - tiw, 1)
    elif t in (ST.utr5init, ST.rutr5init):
        Kl = mel + DSS_MIDDLE + dend + tss_up
        Kh = tss_up + te + dws
    elif t in (ST.utr5internal, ST.rutr5internal,
               ST.utr3internal, ST.rutr3internal):
        Kl = mel + DSS_MIDDLE + dend + aup + astart + ASS_MIDDLE
        Kh = dws + aup + aws
    elif t in (ST.utr5term, ST.rutr5term):
        Kl = mel - tiw + aup + astart + ASS_MIDDLE
        Kh = aup + aws
        if -aup - aws + tiw + aend < 0:
            Kh = aup + aws - tiw - aend
    elif t in (ST.utr3single, ST.rutr3single):
        Kl = uc.max3single
        Kh = dpc + boxlen
    elif t in (ST.utr3init, ST.rutr3init):
        Kl = mel + DSS_MIDDLE + dend
        Kh = dend + DSS_MIDDLE
    else:   # utr3term, rutr3term
        Kl = uc.max3term + ASS_MIDDLE + astart + aup
        Kh = dpc + boxlen + aws + aup

    # begin clamp (gold_utr.utr_cands lo clamps, in b coordinates)
    if t in (ST.utr5single, ST.utr5init):
        b_lo = 1 - tss_up
    elif t in (ST.rutr3single, ST.rutr3term):
        b_lo = 1 - boxlen - dpc
    else:
        b_lo = 1

    # ---- endPart + per-j cum/ipb folds (H side) --------------------------
    ipb_end = 0.0
    if hints_on:
        ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum

    def clipc(x):
        return np.clip(x, 0, n)

    if t in (ST.utr5single, ST.utr5term):
        ebxj = jj + tiw
        p = ebxj + 1
        is_start = np.zeros(n, dtype=bool)
        ok = (p >= 0) & (p + 2 < n)
        pc = np.clip(p, 0, max(n - 3, 0))
        if n >= 3:
            st3 = ((codes[pc] == genetics.A) & (codes[pc + 1] == genetics.T)
                   & (codes[pc + 2] == genetics.G))
            is_start = ok & st3
        gate = (ebxj + 3 > n - 1) | is_start
        end_list = [np.where(gate, 0.0, NEG_INF)] * C
    elif t in (ST.utr5init, ST.utr5internal, ST.utr3init, ST.utr3internal):
        ebxj = jj - dend - DSS_MIDDLE
        start = jj - dws + 1
        ep = np.where(start >= 0, sp.dss_score[np.clip(start, 0, n - 1)],
                      NEG_INF)
        end_list = [ep] * C
    elif t in (ST.rutr5internal, ST.rutr5term, ST.rutr3internal,
               ST.rutr3term):
        ebxj = jj - aup - astart - ASS_MIDDLE
        start = jj - aup - aws + 1
        end_list = [np.where(start >= 0,
                             sp.rass_score[c][np.clip(start, 0, n - 1)],
                             NEG_INF) for c in range(C)]
    elif t in (ST.rutr5single, ST.rutr5init):
        ebxj = jj - tss_up
        bep = jj - tss_up - te + 1
        ok = (bep >= 0) & (bep < n)
        end_list = [np.where(ok, eng.tss_minus[c][np.clip(bep, 0, n - 1)],
                             NEG_INF) for c in range(C)]
    elif t in (ST.utr3single, ST.utr3term):
        # normal (j != n-1) branch; the j == n-1 case is a separate variant
        ebxj = jj.copy()
        bep = jj - dpc - boxlen + 1
        ok = (jj != n - 1) & (bep >= 0) & (bep + boxlen - 1 < n)
        end_list = [np.where(ok, eng.tts_plus[c][np.clip(bep, 0, n - 1)],
                             NEG_INF) for c in range(C)]
    else:   # rutr3single, rutr3init: reverse stop codon right after j
        ebxj = jj.copy()
        rcs = eng.gcode.rc_stop_at(codes)
        ok = (jj + 3 <= n - 1)
        ok[:-1] &= rcs[1:]
        ok[-1] = False if n >= 1 and (n - 1) + 3 > n - 1 else ok[-1]
        end_list = [np.where(ok, 0.0, NEG_INF)] * C
    end_part = np.stack([np.asarray(e, dtype=np.float64) for e in end_list])

    if hints_on and t not in (ST.utr3single, ST.utr3term, ST.rutr5single,
                              ST.rutr5init):
        # intronpart bonus over the intron bases inside the splice windows
        # (gold_utr.utr_cands endPart tail); only when ebx < j
        if int(ebxj[0]) < 0 or (n > 1 and ebxj[1] < 1):
            seg = ipbc[jj + 1] - ipbc[clipc(ebxj + 1)]
            end_part = np.where(end_part > NEG_INF, end_part + seg, end_part)

    tag = str(int(t))
    variants: List[ConvVariant] = []

    def addv(gtag, g_fn, htag, h_arr, len_lo, len_hi, lv,
             vb_lo=None, vb_hi=None):
        len_lo = max(len_lo, Kh, 1)
        if len_lo > len_hi:
            return
        gid = pool.add(f"UG_{tag}_{gtag}",
                       lambda: _f32(g_fn()[:, None, :]), rb=("G", 1))
        hid = pool.add(f"UH_{tag}_{htag}", lambda: _f32(h_arr), rb=("H",))
        variants.append(ConvVariant(
            g_id=gid, h_id=hid, len_lo=len_lo, len_hi=len_hi,
            lenvec=_f32(lv[len_lo - 1:len_hi]), vb_lo=vb_lo, vb_hi=vb_hi))

    # length vector helper: lv_full[L-1] = value for len=L, L in [1, Kl]
    lens = np.arange(1, Kl + 1)

    def _cum(name, cfwd):
        return [eng.cum_utr[(c, name, cfwd)] for c in range(C)]

    # ---- per-state begin/middle/length assembly --------------------------
    # Each state defines: beginp (C, n_ext), middle cum name/strand + bm
    # offset Kb, em offset Ke (em = j - Ke), bob offset (LENGTH = len +
    # Klen), length dist + clip, span fallback mode.
    def beginp_none():
        out = np.zeros((C, n_ext))
        out[:, be < b_lo] = NEG_INF
        return out

    def beginp_track(tracks, idx_off=0, affine_neg=None, neg_cond=None):
        """beginp from per-class tracks at position b+idx_off for b >= 0 (or
        b > 0 when neg_cond='pos'), an affine LQ term where specified, and
        -inf below b_lo / outside [0, n)."""
        out = np.full((C, n_ext), NEG_INF)
        pos = be + idx_off
        ok = (pos >= 0) & (pos < n)
        if neg_cond == "pos":
            sel = (be > 0) & ok
        else:
            sel = (be >= 0) & ok
        for c in range(C):
            trk = tracks[c] if isinstance(tracks, (list, dict)) else tracks
            out[c, sel] = trk[pos[sel]]
        if affine_neg is not None:
            mult, off = affine_neg        # value = (b*mult + off) * LQ
            if neg_cond == "pos":
                nsel = be <= 0
            else:
                nsel = be < 0
            out[:, nsel] = (be[nsel] * mult + off) * LQ
        out[:, be < b_lo] = NEG_INF
        return out

    def gmain(beginp, name, cfwd, Kb):
        cums = _cum(name, cfwd)

        def fn():
            out = beginp.copy()
            bm = np.clip(be + Kb, 0, n)
            for c in range(C):
                out[c] = np.where(out[c] > NEG_INF,
                                  out[c] - cums[c][bm], out[c])
            return out
        return fn

    def hmain(name, cfwd, Ke):
        cums = _cum(name, cfwd)
        em1 = clipc(jj - Ke + 1)
        return np.stack([np.where(end_part[c] > NEG_INF,
                                  end_part[c] + cums[c][em1], end_part[c])
                         for c in range(C)])

    def lv_dist(kind, Klen, clip_max):
        idx = np.clip(lens + Klen, 0, clip_max)
        return ld[kind][idx]

    def span_split(beginp, name, cfwd, Kb, Ke, lvA, fb_log, btag="",
                   vb_lo=None, vb_hi=None):
        """Add the normal (span>=0 / >0) and fallback variants."""
        Csp = Ke + Kb
        if fb_log is None:
            # middle = 0 for len <= Csp (seg clips to zero)
            addv(f"A{btag}", gmain(beginp, name, cfwd, Kb), f"A{btag}",
                 hmain(name, cfwd, Ke), Csp, Kl, lvA, vb_lo, vb_hi)
            addv(f"B{btag}", lambda: beginp, f"B{btag}", end_part,
                 1, Csp - 1, lvA, vb_lo, vb_hi)
        else:
            # fallback -span*log for span < 0 (i.e. len < Csp)
            addv(f"A{btag}", gmain(beginp, name, cfwd, Kb), f"A{btag}",
                 hmain(name, cfwd, Ke), Csp, Kl, lvA, vb_lo, vb_hi)
            lvB = lvA + (Csp - lens) * fb_log
            addv(f"B{btag}", lambda: beginp, f"B{btag}", end_part,
                 1, Csp - 1, lvB, vb_lo, vb_hi)

    if t == ST.utr5single:
        bp = beginp_track(eng.tss_plus, affine_neg=(1.0, tss_up + te - 1))
        span_split(bp, "u5i", True, tss_up + te, 0,
                   lv_dist("5single", tiw - tss_up, mel), LOG2)
    elif t == ST.utr5init:
        bp = beginp_track(eng.tss_plus, affine_neg=(1.0, tss_up + te - 1))
        span_split(bp, "u5i", True, tss_up + te, dws,
                   lv_dist("5initial", -dend - DSS_MIDDLE - tss_up, mel),
                   None)
    elif t == ST.utr5internal:
        bp = beginp_track(sp.ass_score)
        span_split(bp, "u5", True, aup + aws, dws,
                   lv_dist("5internal",
                           -dend - DSS_MIDDLE - aup - astart - ASS_MIDDLE,
                           mel), None)
    elif t == ST.rutr5internal:
        bp = beginp_track(sp.rdss_score)
        span_split(bp, "u5", False, dws, aws + aup,
                   lv_dist("5internal",
                           -aup - astart - ASS_MIDDLE - dend - DSS_MIDDLE,
                           mel), None)
    elif t == ST.utr5term:
        bp = beginp_track(sp.ass_score)
        # beginp invalid when beginOfBioExon >= n (gold_utr utr5term)
        bp[:, be + aup + astart + ASS_MIDDLE >= n] = NEG_INF
        span_split(bp, "u5", True, aup + aws, 0,
                   lv_dist("5terminal", tiw - aup - astart - ASS_MIDDLE,
                           mel), LOG4)
    elif t == ST.rutr5term:
        bp = beginp_none()
        span_split(bp, "u5", False, 0, aws + aup,
                   lv_dist("5terminal", tiw - aup - astart - ASS_MIDDLE,
                           mel), LOG4)
    elif t == ST.rutr5single:
        bp = beginp_none()
        span_split(bp, "u5i", False, 0, tss_up + te,
                   lv_dist("5single", tiw - tss_up, mel), LOG2)
    elif t == ST.rutr5init:
        bp = beginp_track(sp.rdss_score)
        span_split(bp, "u5i", False, dws, tss_up + te,
                   lv_dist("5initial", -dend - DSS_MIDDLE - tss_up, mel),
                   None)
    elif t == ST.utr3init:
        bp = beginp_none()
        span_split(bp, "u3", True, 0, dws,
                   lv_dist("3initial", -dend - DSS_MIDDLE, mel), LOG4)
    elif t == ST.rutr3init:
        bp = beginp_track(sp.rdss_score)
        span_split(bp, "u3", False, dws, 0,
                   lv_dist("3initial", -dend - DSS_MIDDLE, mel), LOG4)
    elif t == ST.utr3internal:
        bp = beginp_track(sp.ass_score)
        span_split(bp, "u3", True, aup + aws, dws,
                   lv_dist("3internal",
                           -dend - DSS_MIDDLE - aup - astart - ASS_MIDDLE,
                           mel), None)
    elif t == ST.rutr3internal:
        bp = beginp_track(sp.rdss_score)
        span_split(bp, "u3", False, dws, aws + aup,
                   lv_dist("3internal",
                           -aup - astart - ASS_MIDDLE - dend - DSS_MIDDLE,
                           mel), None)
    elif t == ST.utr3single:
        bp = beginp_none()
        span_split(bp, "u3", True, 0, dpc + boxlen,
                   lv_dist("3single", 0, uc.max3single), None)
        # j == n-1: end at the sequence end, tail length distribution
        # (gold_utr get_end_positions utr3single + _not_end_part tail)
        h_last = np.full((C, n), NEG_INF)
        cums = _cum("u3", True)
        for c in range(C):
            h_last[c, n - 1] = cums[c][n]
        lv_tail = eng.log_tail3[np.clip(lens, 0,
                                        eng.log_tail3.shape[0] - 1)]
        gid = pool.add(f"UG_{tag}_last", lambda: _f32(
            (gmain(bp, "u3", True, 0)())[:, None, :]), rb=("G", 1))
        hid = pool.add(f"UH_{tag}_last", lambda: _f32(h_last), rb=("H",))
        variants.append(ConvVariant(g_id=gid, h_id=hid, len_lo=1,
                                    len_hi=Kl, lenvec=_f32(lv_tail)))
    elif t == ST.rutr3single:
        bpP = beginp_track(eng.tts_minus, idx_off=dpc, neg_cond="pos")
        bpN = beginp_none()
        bpN[:, be > 0] = NEG_INF
        bm = be + boxlen + dpc
        aff = np.where(bm > 0, (bm - 1) * LQ, 0.0)
        bpN = np.where(bpN > NEG_INF, aff[None, :], bpN)
        span_split(bpP, "u3", False, boxlen + dpc, 0,
                   lv_dist("3single", 0, uc.max3single), None,
                   btag="p", vb_lo=1)
        span_split(bpN, "u3", False, boxlen + dpc, 0,
                   eng.log_tail3[np.clip(lens, 0,
                                         eng.log_tail3.shape[0] - 1)],
                   None, btag="n", vb_hi=0)
    elif t == ST.utr3term:
        bp = beginp_track(sp.ass_score)
        span_split(bp, "u3", True, aup + aws, dpc + boxlen,
                   lv_dist("3terminal",
                           -aup - astart - ASS_MIDDLE, uc.max3term), None)
        # j == n-1 variant (tail length dist, end at sequence end)
        h_last = np.full((C, n), NEG_INF)
        cums = _cum("u3", True)
        for c in range(C):
            h_last[c, n - 1] = cums[c][n]
        Klen3 = -aup - astart - ASS_MIDDLE
        lv_tail = eng.log_tail3[np.clip(lens + Klen3, 0,
                                        eng.log_tail3.shape[0] - 1)]
        gid = pool.add(f"UG_{tag}_last", lambda: _f32(
            (gmain(bp, "u3", True, aup + aws)())[:, None, :]), rb=("G", 1))
        hid = pool.add(f"UH_{tag}_last", lambda: _f32(h_last), rb=("H",))
        variants.append(ConvVariant(
            g_id=gid, h_id=hid, len_lo=max(aws + aup, 1), len_hi=Kl,
            lenvec=_f32(lv_tail[max(aws + aup, 1) - 1:Kl])))
    else:   # rutr3term
        bpP = beginp_track(eng.tts_minus, idx_off=dpc, neg_cond="pos")
        bpN = beginp_none()
        bpN[:, be > 0] = NEG_INF
        bm = be + boxlen + dpc
        bpN = np.where(bpN > NEG_INF, ((bm - 1) * LQ)[None, :], bpN)
        lv3t = lv_dist("3terminal", -aup - astart - ASS_MIDDLE, uc.max3term)
        span_split(bpP, "u3", False, boxlen + dpc, aws + aup, lv3t,
                   None, btag="p", vb_lo=1)
        span_split(bpN, "u3", False, boxlen + dpc, aws + aup, lv3t,
                   None, btag="n", vb_hi=0)

    variants.sort(key=lambda v: v.len_lo)

    end_gate = (end_part > NEG_INF).any(axis=0)
    if t in (ST.utr3single, ST.utr3term):
        end_gate = end_gate.copy()
        end_gate[n - 1] = True

    big = np.int32(1 << 30)
    return ExonConvState(
        state=s, etype=int(t), bpl=0, a_off=1,
        phase_const=0, phase_sign=1, frame_mode=0, win=0, lane=lane,
        end_gate=end_gate,
        start_min=np.full(n, -big, dtype=np.int32),
        start_max=jj.astype(np.int32), variants=variants)


# ---------------------------------------------------------------------------
# ncRNA states (gold_nc.nc_cands, reference src/ncmodel.cc)
# ---------------------------------------------------------------------------

def _nc_geometry(cn, t: ST):
    """(fwd, off_b, bo, Ke, Kb, Kh, Kl) of an nc exon type: bob = b + off_b,
    ebx = j + bo, the middle runs from b + Kb to j - Ke (gold_nc.
    _not_end_part, get_end_positions), the predecessor ends lie in
    [j - Kl, j - Kh] (gold_nc.nc_cands)."""
    dws, aws = cn.dss_whole_size, cn.ass_whole_size
    aup, astart, dend = cn.ass_upwindow_size, cn.ass_start, cn.dss_end
    mel = cn.max_exon_len
    a_in = aup + astart + ASS_MIDDLE       # ass window before the exon
    d_in = dend + DSS_MIDDLE               # dss window after the exon
    single = (1, mel)
    init = (dws, mel + d_in)
    internal = (d_in + a_in + 1, mel + d_in + a_in)
    term = (aup + aws, mel + a_in)
    return {
        ST.ncsingle: (True, 0, 0, 0, 0) + single,
        ST.ncinit: (True, 0, -d_in, dws, 0) + init,
        ST.ncinternal: (True, a_in, -d_in, dws, aup + aws) + internal,
        ST.ncterm: (True, a_in, 0, 0, aup + aws) + term,
        ST.rncsingle: (False, 0, 0, 0, 0) + single,
        ST.rncinternal: (False, d_in, -a_in, aws + aup, dws) + internal,
        ST.rncterm: (False, 0, -a_in, aws + aup, 0) + term,
        ST.rncinit: (False, d_in, 0, 0, dws) + init,
    }[t]


def _nc_reach(eng) -> int:
    """The longest nc exon band back from its end position, in begins
    (b >= 1, so at most the piece's length)."""
    cn = eng.cn
    reach = 0
    for t in (ST.ncsingle, ST.ncinit, ST.ncinternal, ST.ncterm,
              ST.rncsingle, ST.rncinit, ST.rncinternal, ST.rncterm):
        _, off_b, bo, _, _, _, Kl = _nc_geometry(cn, t)
        reach = max(reach, min(Kl, eng.n) + abs(bo) + abs(off_b) + 2)
    return reach


def _nc_chain_emi(eng, s: int, t: ST, anc) -> np.ndarray:
    """ncintron / rncintron: per-base intron content plus the intronpart
    bonus (gold_nc.nc_cands NC_CHAIN branch); the intron malus on entry is
    in the transition column (build_tracks).  At j = 1 every predecessor
    pays it (endOfPred == 0): the self-loop's share is added to the
    emission there, exact while no other ancestor may start the piece,
    which no initial distribution of the architecture allows."""
    C = len(eng.inp.gc)
    n = eng.n
    fwd = t == ST.ncintron
    hints_on = eng.hints is not None
    emi = np.stack([np.asarray(eng.intron_f[c], np.float64).copy()
                    for c in range(C)])
    if hints_on:
        emi += (eng.ipb_plus if fwd else eng.ipb_minus)[None, :]
        li = eng.log_init
        if li[s] > NEG_INF and n > 1:
            # unreachable in the 83-state architecture: the initial
            # distribution is the architecture's own (trans_shadow_partial_
            # utr_nc.pbl [Initial]), where the nc intron's other
            # predecessors, the nc exon states, start no piece (PERF.md,
            # PR 16, "Capacity limits"); a cut piece starts in igenic only
            assert not any(li[p] > NEG_INF for p in anc if p != s), (
                f"state {t.name}: the piece may start in it and in one of "
                "its other predecessors")
            emi[:, 1] += eng.log_malus["intron"]
    return _f32(emi)


def _build_nc_intronvar(eng, s: int, t: ST, lane: int) -> ExonPinnedState:
    """ncintronvar / rncintronvar: the variable-length nc intron that an
    intron hint ending exactly at the splice site gives (gold_nc.
    _nc_intronvar_cands).  The candidates of a position are its hints of
    that end in list order, each adding its bonus to a running quotient
    while the start stays the same.  Where they share one start, the best
    running sum is the position's one candidate (its predecessor and value
    are the same for every sum).  Where they have several starts, every
    candidate is kept in order: the first in eop / score, the others in
    x_pos / x_eop / x_score, of which K2 takes the last maximum and K5 the
    logsumexp."""
    cn, n = eng.cn, eng.n
    sp = eng.splice
    C = len(eng.inp.gc)
    fwd = t == ST.ncintronvar
    strand = "+" if fwd else "-"
    a_in = cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
    d_in = DSS_MIDDLE + cn.dss_end
    min_len = a_in + d_in
    eop = np.full(n, -1, dtype=np.int32)
    score = np.full((C, n), NEG_INF)
    x_pos, x_eop, x_score = [], [], []
    hits: Dict[int, list] = {}
    for f in eng.hints.by_type["intron"]:
        if f.strand in (strand, "."):
            hits.setdefault(f.end, []).append(f)
    d = eng.inp.d
    log_ld_d = float(eng.log_len_intron[d])
    mals = [eng.inp.gc[c].mal for c in range(C)]
    log_geo = [float(np.log(1.0 - 1.0 / m)) if m > 0 else NEG_INF
               for m in mals]

    def cand_score(j: int, e: int, q: float) -> np.ndarray:
        bio_len = (j - (e + 1) + 1) + (d_in if fwd else a_in)
        out = np.empty(C)
        for c in range(C):
            cum = eng.cum_intron_f[c]
            emi = (cum[j + 1] - cum[min(max(e + 1, 0), n)]) + \
                (log_ld_d + (bio_len - d) * log_geo[c])
            out[c] = emi + q
        return out

    for ebi, fs in hits.items():
        j = ebi - (a_in if fwd else d_in)
        if not (0 <= ebi < n) or j < 1 or j >= n:
            continue
        if fwd and not T.is_possible_ass(sp.ass_ok, ebi):
            continue
        if not fwd and not T.is_possible_rdss(sp.rdss_ok, ebi):
            continue
        cands = []
        old_eop, quot = None, 0.0
        for f in fs:
            e = f.start - 1 + (d_in if fwd else a_in)
            if e < 0 or (f.end - f.start + 1) < min_len:
                continue
            quot = quot + float(np.log(f.bonus)) if e == old_eop \
                else float(np.log(f.bonus))
            cands.append((e, quot))
            old_eop = e
        if not cands:
            continue
        if len({e for e, _ in cands}) == 1:
            cands = [(cands[0][0], max(q for _, q in cands))]
        (e, q), rest = cands[0], cands[1:]
        score[:, j] = cand_score(j, e, q)
        eop[j] = e
        for e, q in rest:
            x_pos.append(j)
            x_eop.append(e)
            x_score.append(cand_score(j, e, q))
    ps = ExonPinnedState(state=s, lane=lane, eop=eop, score=_f32(score))
    if x_pos:
        order = np.argsort(np.asarray(x_pos), kind="stable")
        ps.x_pos = np.asarray(x_pos, np.int64)[order]
        ps.x_eop = np.asarray(x_eop, np.int64)[order]
        ps.x_score = _f32(np.stack(x_score, axis=1)[:, order])
    return ps


def _nc_narrow_lo(eng, fwd: bool, bo: int, Kl: int, hi, lo0):
    """The first predecessor end of every position after the hinted-exon
    narrowing (gold_nc.nc_cands, allowOnlyExonHintedNCExons): the least
    start of the exon / exonpart hints that overlap [lo0, ebx], when it
    lies after lo0, moved back to hi - 200 where it is nearer than that."""
    n = eng.n
    min_e = hi + 1
    if eng.hints is not None:
        strand = "+" if fwd else "-"
        minstart = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        for f in eng.hints.ovlping(["exon", "exonpart"], -(1 << 40),
                                   1 << 40, strand):
            if f.end < 0:
                continue
            j0 = max(f.start - bo, 0)
            j1 = min(f.end + Kl, n - 1)
            if j0 <= j1:
                np.minimum(minstart[j0: j1 + 1], f.start,
                           out=minstart[j0: j1 + 1])
        min_e = np.minimum(min_e, minstart)
    lo = np.where(min_e > lo0, min_e, lo0)
    return np.where((min_e > lo0) & (lo > hi - 200),
                    np.maximum(hi - 200, 0), lo)


def _build_nc_conv(eng, s: int, t: ST, lane: int, pool: Pool, gpad: int):
    """One nc exon state as banded max-plus convolution variants (gold
    oracle: gold_nc.nc_cands / _not_end_part).  With a_off = bo - off_b + 1,
    len := j + a_off - b is the biological exon length ebx - bob + 1.  The
    begin-side terms (tss/tts track or splice score at b, -cum at the
    middle's start, and with hints the dss/ass adjustment at bob - 1 and
    the intronpart bonus of the leading splice window) are functions of b
    (G); the end part (tss/tts track or splice score, its hint
    adjustments, +cum at the middle's end) of j (H); the length
    distribution and the ncterm / rncterm -span*log 4 fallback of short
    exons fold into the length vectors, split where the middle's span
    changes sign.  The hinted-exon narrowing is the per-position
    [start_min, start_max]; the hint quotient (extrinsicQuot, ncmodel.cc
    :575-674) is exclass 4 of the sparse hint machinery."""
    cn, n = eng.cn, eng.n
    C = len(eng.inp.gc)
    sp = eng.splice
    hints_on = eng.hints is not None
    fwd, off_b, bo, Ke, Kb, Kh, Kl = _nc_geometry(cn, t)
    a_off = bo - off_b + 1
    jj = np.arange(n)
    be = np.arange(-gpad, n + END_PAD)       # extended begin domain
    n_ext = be.shape[0]

    def gather(arr, idx, size):
        ok = (idx >= 0) & (idx < size)
        return np.where(ok, np.asarray(arr)[np.clip(idx, 0, size - 1)],
                        NEG_INF)

    # ---- end part (H side, before the middle's cum) ----------------------
    if t in (ST.ncsingle, ST.ncterm):
        end_list = [eng.nc_tts_plus[:n]] * C
    elif t in (ST.rncsingle, ST.rncinit):
        end_list = [eng.nc_tss_minus[:n]] * C
    elif t in (ST.ncinit, ST.ncinternal):
        end_list = [gather(sp.dss_score, jj - cn.dss_whole_size + 1, n)] * C
    else:   # rncterm, rncinternal
        bep = jj - cn.ass_whole_size - cn.ass_upwindow_size + 1
        end_list = [gather(sp.rass_score[c], bep, n) for c in range(C)]
    end_part = np.stack([np.asarray(e, dtype=np.float64) for e in end_list])
    ebx = jj + bo
    if hints_on:
        adj = 0.0
        if t in (ST.ncinternal, ST.ncinit):
            adj = eng.nc_dss_adj_p[np.minimum(ebx + 1, n)]
        elif t in (ST.rncinternal, ST.rncterm):
            adj = eng.nc_ass_adj_m[np.minimum(ebx + 1, n)]
        if t in (ST.ncinit, ST.ncinternal, ST.rncterm):
            ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
            adj = adj + np.where(ebx < jj, ipbc[np.minimum(jj + 1, n)]
                                 - ipbc[np.clip(ebx + 1, 0, n)], 0.0)
        end_part = np.where(end_part > NEG_INF, end_part + adj, end_part)

    # ---- begin part (G side, before the middle's cum) --------------------
    bob = be + off_b
    if t in (ST.ncsingle, ST.ncinit):
        bp1 = gather(eng.nc_tss_plus, be, n + 1)
        begin = np.broadcast_to(bp1, (C, n_ext))
    elif t in (ST.rncsingle, ST.rncterm):
        bp1 = gather(eng.nc_tts_minus, be, n + 1)
        begin = np.broadcast_to(bp1, (C, n_ext))
    elif t in (ST.ncinternal, ST.ncterm):
        begin = np.stack([gather(sp.ass_score[c], be, n) for c in range(C)])
        if t == ST.ncterm:
            begin = np.where(bob[None, :] >= n, NEG_INF, begin)
    else:   # rncinternal, rncinit
        bp1 = gather(sp.rdss_score, be, n)
        begin = np.broadcast_to(bp1, (C, n_ext))
    begin = np.array(begin, dtype=np.float64)
    if hints_on:
        if t in (ST.rncinternal, ST.rncinit):
            begin = begin + gather(eng.nc_dss_adj_m, bob - 1, n + 1)[None, :]
        if t in (ST.ncinternal, ST.ncterm):
            begin = begin + gather(eng.nc_ass_adj_p, bob - 1, n + 1)[None, :]
        if t in (ST.ncinternal, ST.ncterm, ST.rncinternal, ST.rncinit):
            ipbc = eng.ipb_plus_cum if fwd else eng.ipb_minus_cum
            l_ = np.clip(be, 0, n)
            r_ = np.clip(bob, 0, n)
            begin = begin + np.where(l_ < r_, ipbc[r_] - ipbc[np.minimum(
                l_, r_)], 0.0)[None, :]

    # ---- lengths ---------------------------------------------------------
    single = t in (ST.ncsingle, ST.rncsingle)
    ld = eng.log_len_ncsingle if single else eng.log_len_ncinternal
    len_min = a_off + Kh - 1
    len_max = min(a_off + Kl - 1, n + a_off)
    lens = np.arange(len_min, len_max + 1)
    ok = (lens >= 0) & (lens <= ld.shape[0] - 1)
    lv_all = np.where(ok, ld[np.clip(lens, 0, ld.shape[0] - 1)], NEG_INF)
    Csp = a_off + Ke + Kb - 1                # span >= 0 from this length on
    fallback = t in (ST.ncterm, ST.rncterm)

    tag = str(int(t))
    variants: List[ConvVariant] = []
    cums = [eng.cum_intron_f[c] for c in range(C)]

    def addv(vtag, g_arr, h_arr, lo_, hi_, lv):
        if lo_ > hi_:
            return
        gid = pool.add(f"NG_{tag}_{vtag}", lambda: _f32(g_arr[:, None, :]),
                       rb=("G", 1))
        hid = pool.add(f"NH_{tag}_{vtag}", lambda: _f32(h_arr), rb=("H",))
        variants.append(ConvVariant(
            g_id=gid, h_id=hid, len_lo=lo_, len_hi=hi_,
            lenvec=_f32(lv[lo_ - len_min: hi_ - len_min + 1])))

    # B: the middle is empty (span < 0): no content, or the fallback
    lvB = lv_all + ((Csp - lens) * LOG4 if fallback else 0.0)
    addv("B", begin, end_part, len_min, min(Csp - 1, len_max), lvB)
    # A: the middle's content cum[j - Ke + 1] - cum[b + Kb]
    gA = np.stack([np.where(begin[c] > NEG_INF,
                            begin[c] - cums[c][np.clip(be + Kb, 0, n)],
                            NEG_INF) for c in range(C)])
    hA = np.stack([np.where(end_part[c] > NEG_INF,
                            end_part[c] + cums[c][np.clip(jj - Ke + 1, 0, n)],
                            NEG_INF) for c in range(C)])
    addv("A", gA, hA, max(Csp, len_min), len_max, lv_all)

    # ---- per-position band: ends in [lo, hi], b = end + 1 ----------------
    hi = jj - Kh
    lo0 = np.maximum(jj - Kl, 0)
    lo = _nc_narrow_lo(eng, fwd, bo, Kl, hi, lo0)
    end_gate = (end_part > NEG_INF).any(axis=0) & (hi >= lo)
    ecs = ExonConvState(
        state=s, etype=int(t), bpl=0, a_off=a_off,
        phase_const=0, phase_sign=1, frame_mode=0, win=0, lane=lane,
        end_gate=end_gate, start_min=(lo + 1).astype(np.int32),
        start_max=(hi + 1).astype(np.int32), variants=variants)
    if hints_on:
        ecs.hint_strand = "nc+" if fwd else "nc-"
        ecs.hint_ipo = -off_b
        ecs.hint_bo = bo
        ecs.hint_exclass = 4
    return ecs


# ---------------------------------------------------------------------------
# Sparse exon-hint machinery (exonpart/CDSpart/exon/CDS quotients)
# ---------------------------------------------------------------------------
#
# gold._exon_part_quot (reference exonmodel.cc:1769-1860) scores each exon
# candidate [bob, ebx] against the hint set.  On device this decomposes as
#
#   quot(j, b) = separable(b) + separable(j) + clamps(window arithmetic)
#              + covering corrections + exact boundary matches
#
# via cumulative tracks:
#   BE(x)   = sum of log-bonus over hints with end <= x
#   CR(p)   = sum over hints crossing p (start < p <= end)
#   C2(x)   = sum over hints with start <= x < end
#   Cnt*(x) = count versions; ZC(x) = zero-coverage cumsum (local malus)
# so e.g.  sum over hints INSIDE [bob, ebx]
#        = BE(ebx) - BE(bob-1) - CR(bob) + Cov(b, j)
# where Cov(b, j) = sum over hints with start < bob and end > ebx.  Cov is
# the only non-separable term; every such hint crosses ebx, so with
#   TX(x)   = sum over hints crossing x
#   steps(x) = the (start, w) list of hints crossing x
# Cov = TX(ebx) - sum_k w_k * [start_k >= bob] -- a handful of per-x step
# entries (bounded by the hint crossing depth, K-capped).  Exact boundary
# matches (CDS ==, exon == / one-sided) are per-x point/step entries.

EXON_HINT_KINDS = ("exonpart", "CDSpart", "exon", "CDS")


@dataclass
class HintTables:
    """Per-strand hint tracks + per-x correction tables."""
    # b-indexed window rows over the extended domain [-gpad, n+END_PAD):
    # dict name -> (n_ext,) f32
    wrows: Dict[str, np.ndarray]
    # x-indexed 1-D tracks over [0, n) (baked into scalar cols at x=j+bo)
    xrows: Dict[str, np.ndarray]
    # crossing step tables: (n, K) arrays
    cross_start: np.ndarray       # int32, -2**30 when empty
    cross_w: np.ndarray           # f32 log-bonus
    cross_flag: np.ndarray        # int32 bitmask: 1=ep 2=cp 4=exon
    # exact-match tables at x == hint end: (n, K2)
    ex_pos: np.ndarray            # int32 bob value / threshold
    ex_w: np.ndarray              # f32
    ex_kind: np.ndarray           # int32: 1=CDS point, 2=exonI point,
    #                               3=exonLT step (bob > pos)


def _hint_tables_cached(eng, gpad: int) -> Dict[str, HintTables]:
    """Per-engine cache of the hint tables (_build_pinned and the final
    build_tracks assembly share one construction)."""
    cache = getattr(eng, "_ht_cache", None)
    if cache is None:
        cache = eng._ht_cache = {}
    if gpad not in cache:
        cache[gpad] = _build_hint_tables(eng, gpad)
    return cache[gpad]


def _build_hint_tables(eng, gpad: int) -> Dict[str, HintTables]:
    """Build per-strand HintTables from the prepared SeqHints."""
    h = eng.hints
    out = {}
    for strand in ("+", "-"):
        def sok(f):
            return f.strand in (strand, ".")

        exs = [f for f in h.by_type["exon"] if sok(f)]
        # an exon hint is a point entry for internal exons (kind 2) and a
        # step for initial ones (kind 3); CDS hints a point (kind 1)
        exact = [(f, 1) for f in h.by_type["CDS"] if sok(f)] + \
            [(f, k) for f in exs for k in (2, 3)]
        # zero-coverage cums for the local malus (gold cumcov_cp_*)
        zc = getattr(eng, "cumcov_cp_plus" if strand == "+"
                     else "cumcov_cp_minus")
        out[strand] = _hint_tables_of(
            eng.n, gpad,
            eps=[f for f in h.by_type["exonpart"] if sok(f)],
            cps=[f for f in h.by_type["CDSpart"] if sok(f)], exs=exs,
            exact=exact,
            # any-strand end counts (numEPendingInExon ignores strand)
            end_eps=h.by_type["exonpart"], end_cps=h.by_type["CDSpart"],
            zc=zc)
    return out


def _nc_hint_tables(eng, gpad: int) -> Dict[str, HintTables]:
    """The nc model's HintTables, keys "nc+" and "nc-" (gold_nc.
    _not_end_part's extrinsicQuot, the quotient class 4 of scan.py and
    csrc/k2_common.cuh): exonpart hints of the strand or '.' for the part
    bonus, the end counts and the crossings; exon hints of exactly the
    strand as point matches (kind 2); no CDSpart or CDS rows; the
    zero-coverage cums of the exonpart hints (nc_cumcov_ep_*) for the
    local malus."""
    h = eng.hints
    out = {}
    for strand in ("+", "-"):
        eps = h.ovlping("exonpart", -(1 << 40), 1 << 40, strand)
        zc = eng.nc_cumcov_ep_plus if strand == "+" \
            else eng.nc_cumcov_ep_minus
        out["nc" + strand] = _hint_tables_of(
            eng.n, gpad, eps=eps, cps=[], exs=[],
            exact=[(f, 2) for f in h.by_type["exon"] if f.strand == strand],
            end_eps=eps, end_cps=[], zc=zc)
    return out


def _hint_tables_of(n: int, gpad: int, eps, cps, exs, exact, end_eps,
                    end_cps, zc) -> HintTables:
    """One HintTables: eps / cps the exonpart / CDSpart hints of the part
    bonus, exs the exon hints of the crossing table's flag 4, exact the
    (hint, kind) entries of the exact-match table at x = the hint's end,
    end_eps / end_cps the hints of the end counts, zc the zero-coverage
    cumsum of the local malus."""
    n_ext = gpad + n + END_PAD

    def cum_end(feats, w=True):
        a = np.zeros(n)
        for f in feats:
            if 0 <= f.end < n:
                a[f.end] += np.log(f.bonus) if w else 1.0
        return np.cumsum(a)

    def cross(feats, w=True):
        """CR(p) = sum over start < p <= end."""
        a = np.zeros(n + 1)
        for f in feats:
            lo, hi = f.start + 1, f.end + 1   # p in [start+1, end]
            a[max(lo, 0): max(min(hi, n), 0)] += \
                np.log(f.bonus) if w else 1.0
        return a[:n]

    def cross2(feats, w=True):
        """C2(x) = sum over start <= x < end."""
        a = np.zeros(n + 1)
        for f in feats:
            a[max(f.start, 0): max(min(f.end, n), 0)] += \
                np.log(f.bonus) if w else 1.0
        return a[:n]

    wrows = {}
    xrows = {}

    def put_both(name, arr):
        ext = np.zeros(n_ext, dtype=np.float32)
        ext[gpad: gpad + n] = arr
        ext[gpad + n:] = arr[-1] if n else 0.0
        wrows[name] = ext
        xrows[name] = np.asarray(arr, dtype=np.float64)

    put_both("BE_ep", cum_end(eps))
    put_both("BE_cp", cum_end(cps))
    put_both("CntBE_ep", cum_end(eps, w=False))
    put_both("CntBE_cp", cum_end(cps, w=False))
    put_both("CR_ep", cross(eps))
    put_both("CR_cp", cross(cps))
    put_both("CntCR_ep", cross(eps, w=False))
    put_both("CntCR_cp", cross(cps, w=False))
    xrows["C2_ep"] = cross2(eps)
    xrows["CntC2_ep"] = cross2(eps, w=False)
    put_both("CntE_ep", cum_end(end_eps, w=False))
    put_both("CntE_cp", cum_end(end_cps, w=False))
    put_both("ZC", zc.astype(np.float64))

    # crossing tables: hints crossing x, for Cov + terminal exon matches
    lists = [[] for _ in range(n)]
    for flag, feats in ((1, eps), (2, cps), (4, exs)):
        for f in feats:
            for x in range(max(f.start, 0), min(f.end, n)):
                lists[x].append((f.start, float(np.log(f.bonus)), flag))
    K = max((len(l) for l in lists), default=0)
    cross_start = np.full((n, max(K, 1)), -(1 << 30), dtype=np.int32)
    cross_w = np.zeros((n, max(K, 1)), dtype=np.float64)
    cross_flag = np.zeros((n, max(K, 1)), dtype=np.int32)
    for x, l in enumerate(lists):
        for k, (st_, w_, fl_) in enumerate(l):
            cross_start[x, k] = st_
            cross_w[x, k] = w_
            cross_flag[x, k] = fl_
    if K == 0:
        cross_start = cross_start[:, :0]
        cross_w = cross_w[:, :0]
        cross_flag = cross_flag[:, :0]
    # TX sums per x
    for nm, flag, w in (("TX_ep", 1, True), ("TX_cp", 2, True),
                        ("TXc_ep", 1, False), ("TXc_cp", 2, False)):
        a = np.zeros(n)
        if cross_start.shape[1]:
            sel = cross_flag == flag
            a = np.sum(np.where(sel, cross_w if w else 1.0, 0.0), axis=1)
        xrows[nm] = a

    # exact tables keyed by x = hint end
    lists2 = [[] for _ in range(n)]
    for f, kind in exact:
        if 0 <= f.end < n:
            lists2[f.end].append((f.start, float(np.log(f.bonus)), kind))
    K2 = max((len(l) for l in lists2), default=0)
    ex_pos = np.full((n, max(K2, 1)), -(1 << 30), dtype=np.int32)
    ex_w = np.zeros((n, max(K2, 1)), dtype=np.float64)
    ex_kind = np.zeros((n, max(K2, 1)), dtype=np.int32)
    for x, l in enumerate(lists2):
        for k, (p_, w_, kd_) in enumerate(l):
            ex_pos[x, k] = p_
            ex_w[x, k] = w_
            ex_kind[x, k] = kd_
    if K2 == 0:
        ex_pos = ex_pos[:, :0]
        ex_w = ex_w[:, :0]
        ex_kind = ex_kind[:, :0]
    return HintTables(
        wrows=wrows, xrows=xrows, cross_start=cross_start,
        cross_w=cross_w, cross_flag=cross_flag,
        ex_pos=ex_pos, ex_w=ex_w, ex_kind=ex_kind)
