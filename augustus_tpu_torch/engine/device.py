"""DP tracks: factorized per-state score arrays (host copy of
augustus_tpu/engine/device.py for the no-UTR, no-hint architecture).

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
        xp = np
        fin = xp.isfinite(x.hi)
        hi = xp.maximum(xp.where(fin, x.hi, np.float64(F32_NEG)),
                        np.float64(F32_NEG))
        lo = xp.where(fin & (x.hi > float(F32_NEG) / 2), x.lo,
                      xp.zeros_like(x.lo))
        return U.DD(hi, lo)
    return U.sanitize(x)


def _c32(x):
    return U.sanitize(U.val(x)).astype(np.float32)


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


@dataclass
class ExonPinnedState:
    state: int
    lane: int
    eop: np.ndarray               # (n,) int32, -1 invalid
    score: np.ndarray             # (C, n) f32 endPart+notEnd, -inf invalid


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

    # no hints in this package: the per-base intronpart bonus of the
    # geometric states is zero (kept as an explicit add so every table
    # rounds exactly as in augustus_tpu)
    ipb_p = ipb_m = np.zeros(n)

    # superwindow back-extent: must cover the longest banded variant
    gpad = CONV_CAP + 96

    tr = DPTracks(n=n, S=S, n_classes=C, n_lanes=0, gpad=gpad,
                  stairs=eng.stairs.astype(np.int32),
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
    xp = np

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
            per_c = []
            for c in range(C):
                src = sp.ass_score[c] if fwd else sp.rass_score[c]
                sel = (start >= 0) & gate
                emi = U.where(sel, U.sg(src, 1 - jump, n), NEG_INF)
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
            per_c = []
            for c in range(C):
                cum = eng.cum_intron_f[c]    # requalD also fwd (quirk)
                seg = U.val(U.sg(cum, 1, n) - U.sg(cum, 1 - dsl, n))
                emi = xp.where(ok_j, seg, NEG_INF)
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
        else:
            # UTR and ncRNA states are later slices of the port
            raise NotImplementedError(
                f"state type {t.name}: only the 47-state shadow/partial "
                "architecture (--UTR=off, no ncRNA) is ported")

    NL = len(lane_rows)
    tr.n_lanes = NL
    tr.lane_trans = np.stack(lane_rows).astype(np.float32)
    tr.lane_target = np.array(lane_tgt, dtype=np.int32)
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
    xp = np
    n = tr.n
    stairs = tr.stairs.astype(np.int64)
    ig_all = U.stk([eng.ig_track[c] for c in range(len(eng.inp.gc))])
    igj = U.class_pick(ig_all, stairs)
    # dbase[p] = base[p] - base[p-1] exactly (igj with the p=0 entry zeroed)
    dbase = xp.concatenate([xp.zeros(1, dtype=igj.dtype), igj[1:]]) \
        if n > 1 else xp.zeros(n, dtype=igj.dtype)
    base_dd = U.DD.cumsum_dd(dbase)
    tr.base = np.asarray(U.val(base_dd)) if True \
        else U.val(base_dd)

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
    # intronpart bonus cums fold into the content cums; the intron malus
    # folds into the length vector (gold._lessd_cands hint branch)
    ipbc = 0.0
    lm_intron = 0.0
    cum_key = ("cum_intron_f" if fwd else "cum_intron_r") + \
        ""
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

    xp = np
    c64_ = codes.astype(np.int64)

    def ch_sh(c):
        idx = j + c
        ok = (idx >= 0) & (idx < n)
        return xp.where(ok, U.sg(c64_, c, n), np.int64(genetics.N))

    def ch(idx):
        ok = (idx >= 0) & (idx < n)
        return xp.where(ok, codes[xp.clip(idx, 0, n - 1)].astype(np.int64),
                        np.int64(genetics.N))

    past = ebi >= n - 2
    r1 = xp.where(past, np.int64(genetics.N), ch_sh(c_ebi + 1))
    r2 = xp.where(past, np.int64(genetics.N), ch_sh(c_ebi + 2))
    comp = U.asarr(genetics.COMPLEMENT)
    A, G, Tb, Nb = genetics.A, genetics.G, genetics.T, genetics.N
    b_stop = np.zeros(n, dtype=np.int8)
    j_sel = np.zeros(n, dtype=np.int8)
    if t == ST.lessD1:
        l0 = ch_sh(c_bbi - 1)
        b_stop = (guard & (l0 == Tb)).astype(np.int8)
        j_sel = (((r1 == A) & ((r2 == A) | (r2 == G))) |
                 ((r1 == G) & (r2 == A))).astype(np.int8)
    elif t == ST.lessD2:
        l0 = ch_sh(c_bbi - 2)
        l1 = ch_sh(c_bbi - 1)
        case_ta = guard & (l0 == Tb) & (l1 == A)
        case_tg = guard & (l0 == Tb) & (l1 == G)
        b_stop = case_ta.astype(np.int8) | (case_tg.astype(np.int8) << 1)
        # stop iff (ta & r1 in {a,g}) | (tg & r1==a)
        j_sel = ((r1 == A) | (r1 == G)).astype(np.int8) | \
            ((r1 == A).astype(np.int8) << 1)
    elif t == ST.rlessD0:
        l1 = ch_sh(c_bbi - 1)
        l2 = ch_sh(c_bbi - 2)
        c1 = comp[xp.clip(l1, 0, 4)]
        c2 = comp[xp.clip(l2, 0, 4)]
        b_stop = (guard & (((c1 == A) & ((c2 == A) | (c2 == G))) |
                           ((c1 == G) & (c2 == A)))).astype(np.int8)
        cr1 = comp[xp.clip(r1, 0, 4)]
        j_sel = (cr1 == Tb).astype(np.int8)
    elif t == ST.rlessD1:
        l1 = ch_sh(c_bbi - 1)
        c2 = comp[xp.clip(l1, 0, 4)]
        cr1 = comp[xp.clip(r1, 0, 4)]
        cr2 = comp[xp.clip(r2, 0, 4)]
        case_ta = (cr2 == Tb) & (cr1 == A)
        case_tg = (cr2 == Tb) & (cr1 == G)
        b_stop = (guard & ((c2 == A) | (c2 == G))).astype(np.int8) | \
            ((guard & (c2 == A)).astype(np.int8) << 1)
        j_sel = case_ta.astype(np.int8) | (case_tg.astype(np.int8) << 1)
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

# ---------------------------------------------------------------------------

def _build_pinned(eng: GoldEngine, s: int, t: ST, lane: int, gpad: int
                  ) -> ExonPinnedState:
    """rterminal*/rsingleG: single begin candidate b = ORFleft+2 per j
    (reference exonmodel.cc:1044).  Vectorized over all j from the dense
    tracks (gold oracle: gold._not_end_part at start_min == start_max,
    gold.py:951-952)."""
    xp = np
    cn, n = eng.cn, eng.n
    g = eng.geom[t]
    C = len(eng.inp.gc)
    k = eng.exp.k
    log_nc = float(np.log(cn.prob_n_in_coding))
    L3 = float(np.log(3.0))
    j = U.arange(n)

    if t == ST.rsingleG:
        ends = [eng.tis_end_rev[c] for c in range(C)]
    else:
        asspos = j + cn.ass_end + 1
        gate = (j == n - 1) | ((j + cn.ass_end + ASS_MIDDLE < n) &
                               T.is_possible_rass_sh(eng.splice.rass_ok,
                                                     cn.ass_end + 1))
        end = xp.where(gate, 0.0, NEG_INF)
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
    eop_arr = xp.where(live, eop, -1).astype(np.int32)
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

    lm = {}
    xp = np

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
        else:   # rinitial, rinternal*
            blocked = (bob < 0) | ((bob - DSS_MIDDLE > 0) &
                                   ~T.is_possible_rdss_sh(
                                       sp.rdss_ok,
                                       -g.inner_part_offset - 1))
            bt = xp.where(b == 0, 0.0, xp.where(blocked, NEG_INF, 0.0))
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
        end_part = U.stk([gate for _ in range(C)])
    else:   # rinternal*
        asspos = j + cn.ass_end + 1
        mid = (j < n - 1) & (j + cn.ass_end + ASS_MIDDLE < n) & \
            T.is_possible_rass_sh(sp.rass_ok, cn.ass_end + 1)
        gate = xp.where((j == n - 1) | mid, 0.0, NEG_INF)
        end_part = U.stk([gate for _ in range(C)])
    # separable part of the exonpart/CDS hint quotient
    # (gold._exon_part_quot with no exonpart/CDSpart/exon/CDS hints):
    # exon_len*(malus_ep + malus_cp) + malus_exon + malus_CDS.  The linear
    # term folds into the length vectors, the constants into endPart.
    # With such hints present the sparse HintCorr machinery replaces this.
    lm_lin = 0.0

    end_gate = (end_part > NEG_INF).any(axis=0)

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
        sel = np.arange(m_ids)
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
        sel = np.arange(m_ids)
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
    orf_left = T.leftmost_exon_begin(eng.orf, f_eon, eon, fwd, cn,
                                     n).astype(np.int64)
    smax = (j + g.base_offset) + g.inner_part_offset - cn.min_exon_length + 1
    smax = xp.minimum(smax, j + g.begin_part_len)
    smin = xp.where(orf_left <= 0, 0, orf_left + g.inner_part_offset)

    ecs = ExonConvState(
        state=s, etype=int(t), bpl=g.begin_part_len, a_off=a_off,
        phase_const=phase_const, phase_sign=phase_sign,
        frame_mode=frame_mode, win=g.win, lane=lane,
        end_gate=end_gate, start_min=smin.astype(np.int32),
        start_max=smax.astype(np.int32), variants=variants)
    return ecs
