"""Scalar-table consolidation of the DP tracks (numpy, or torch tensors
inside xputil.use_torch).

Counterpart of `split_tracks` from `augustus_tpu/engine/scan.py`: the per-state
track lists of a DPTracks are consolidated into one (n, NSC) float32 table
and one (n, NIC) int32 table (GC class baked in per position), plus the
G/cum pools and lessD masks, and the sparse exon/CDS hint machinery (window
rows `hw_all`, per-position hint columns and the `HintConvStatic` of every
hinted conv, host route only).  engine/pack.py turns these into the
64-state Viterbi kernel's planes.  `needs_general_scan` names the pieces
that the 64-state recursion cannot take (more than 64 states or lanes, or
the UTR states); the reference decodes none of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..model.state_config import ST
from .device import DPTracks, F32_NEG, END_PAD
from . import xputil as U


@dataclass(frozen=True)
class VariantStatic:
    g_id: int                 # row in G_all
    h_col: int                # column in the scalar table
    len_lo: int
    len_hi: int
    width: int
    fsel: Optional[tuple]
    vb_lo: Optional[int] = None   # absolute begin-position bounds (UTR)
    vb_hi: Optional[int] = None


@dataclass(frozen=True)
class HintConvStatic:
    """Sparse exon-hint machinery for one conv state (device.HintTables).

    Window-row indices index hw_all; x-side values are scalar columns
    pre-shifted to x = j + base_offset; cross/ex entry fields are
    (int_col, scal_col, int_col) triples per K slot.
    """
    ipo: int
    aL: bool
    aR: bool
    exclass: int
    w_be_ep: int; w_be_cp: int; w_cntbe_ep: int; w_cntbe_cp: int
    w_cr_ep: int; w_cr_cp: int; w_cntcr_ep: int; w_cntcr_cp: int
    w_cnte_ep: int; w_cnte_cp: int; w_zc: int
    x_be_ep: int; x_be_cp: int; x_cntbe_ep: int; x_cntbe_cp: int
    x_c2_ep: int; x_cntc2_ep: int
    x_cnte_ep: int; x_cnte_cp: int; x_zc: int
    x_tx_ep: int; x_tx_cp: int; x_txc_ep: int; x_txc_cp: int
    cross_cols: tuple
    ex_cols: tuple


@dataclass(frozen=True)
class ConvStatic:
    state: int
    bpl: int
    a_off: int
    lane: int
    frame_mode: int
    smin_col: int             # int-table columns
    smax_col: int
    gate_col: int
    variants: Tuple[VariantStatic, ...]
    hint: Optional[HintConvStatic] = None


@dataclass(frozen=True)
class ChainStatic:
    state: int
    emi_col: int


@dataclass(frozen=True)
class FixedStatic:
    state: int
    jump: int
    kind: int
    lane: int
    emi_col: int
    extra_col: int            # kind1: log(1-psi); kind2: log geo->ass; else -1


@dataclass(frozen=True)
class LessDStatic:
    state: int
    lane: int
    window: int
    cum_id: int               # row in cum_all
    cumj_col: int             # scalar col: cum[c(j), j+1]
    psi_col: int              # scalar col: log psi[c(j)]
    jsel_col: int             # int col
    jgate_col: int            # int col
    lenvec_key: str


@dataclass(frozen=True)
class PinnedStatic:
    state: int
    lane: int
    score_col: int
    eop_col: int              # int col
    # positions with several candidates (nc intron hints of one end and
    # several starts): an int col holding, at such a position, the offset
    # of its list in arrays[x_key] ([count, then (eop, score) per
    # candidate after the first], float32), -1 elsewhere; -1 / None when
    # no position has more than one
    x_col: int = -1
    x_key: Optional[str] = None


@dataclass(frozen=True)
class ScanStatic:
    n: int
    S: int
    NL: int
    C: int
    PAD: int
    GPAD: int
    NSC: int
    NIC: int
    chain: Tuple[ChainStatic, ...]
    fixed: Tuple[FixedStatic, ...]
    lessd: Tuple[LessDStatic, ...]
    pinned: Tuple[PinnedStatic, ...]
    convs: Tuple[ConvStatic, ...]
    cls_col: int              # int col of the GC class
    NHW: int = 0              # hint window rows in hw_all
    hint_lm: Optional[tuple] = None   # (lm_ep, lm_cp, lm_exon, lm_CDS,
    #                                    lm_local_cp[, lm_local_ep: nc])


def _pinned_lists(ps, cls):
    """(the float32 lists of a pinned state's further candidates, the
    (n,) int32 offset of each position's list or -1): a list is [count,
    then eop and score for each candidate], the score of the position's GC
    class."""
    n = ps.eop.shape[0]
    at = np.full(n, -1, dtype=np.int32)
    cls = np.asarray(cls)
    out: List[float] = []
    pos = np.asarray(ps.x_pos)
    for j in np.unique(pos):
        ks = np.flatnonzero(pos == j)
        at[j] = len(out)
        out.append(float(len(ks)))
        for k in ks:
            out += [float(ps.x_eop[k]),
                    float(np.float32(ps.x_score[int(cls[j]), k]))]
    return np.asarray(out, np.float32), at


def split_tracks(tr: DPTracks):
    """(static, arrays) decomposition with scalar-table consolidation."""
    xp = U.A.xp
    GPAD = tr.gpad
    PAD = GPAD
    C = tr.n_classes
    n = tr.n
    cls = U.astype(tr.stairs, np.int64)
    pos = U.arange(n)

    # columns are collected contiguously and stacked once at the end:
    # writing them straight into a row-major (n, NSC) buffer looks
    # cheaper but the strided a[:, k] stores are cache-hostile at Mb
    # scale (measured 2x slower than np.stack's blocked transpose)
    scal_cols: List[np.ndarray] = []
    int_cols: List[np.ndarray] = []

    def scol(values: np.ndarray) -> int:
        scal_cols.append(U.astype(xp.asarray(values), np.float32))
        return len(scal_cols) - 1

    def icol(values: np.ndarray) -> int:
        int_cols.append(U.astype(xp.asarray(values), np.int32))
        return len(int_cols) - 1

    cls_col = icol(cls)

    arrays: Dict[str, object] = {}
    arrays["log_trans"] = tr.log_trans
    arrays["log_init"] = tr.log_init
    arrays["log_term"] = tr.log_term
    arrays["lane_trans"] = tr.lane_trans

    # ---- chain / fixed -------------------------------------------------
    chain_s = tuple(ChainStatic(cs.state, scol(U.class_pick(cs.emi, cls)))
                    for cs in tr.chain)
    fixed_s = []
    for fs in tr.fixed:
        extra = -1
        if fs.kind == 1:
            extra = scol(U.class_pick(xp.asarray(tr.log_1mpsi)[:, None]
                                      + xp.zeros((1, n)), cls))
        elif fs.kind == 2:
            extra = scol(U.class_pick(
                xp.asarray(tr.log_geo_ass)[:, fs.state][:, None]
                + xp.zeros((1, n)), cls))
        fixed_s.append(FixedStatic(fs.state, fs.jump, fs.kind, fs.lane,
                                   scol(U.class_pick(fs.emi, cls)), extra))

    # ---- pool partition ------------------------------------------------
    g_ids, cum_ids = [], []
    for ecs in tr.exon_conv:
        for var in ecs.variants:
            if var.g_id not in g_ids:
                g_ids.append(var.g_id)
    for ls in tr.lessd:
        if ls.cum_id not in cum_ids:
            cum_ids.append(ls.cum_id)
    g_map = {pid: i for i, pid in enumerate(g_ids)}
    cum_map = {pid: i for i, pid in enumerate(cum_ids)}

    def pad_last(arr, fill=F32_NEG):
        front = arr.shape[:-1] + (GPAD,)
        back = arr.shape[:-1] + (END_PAD,)
        return xp.concatenate(
            [xp.full(front, fill, dtype=arr.dtype), arr,
             xp.full(back, fill, dtype=arr.dtype)], axis=-1)

    ext_len = GPAD + n + END_PAD
    G_list = []
    for pid in g_ids:
        a = tr.pool[pid]
        if a.shape[1] == 1:
            a = xp.broadcast_to(a, (a.shape[0], 3, a.shape[2]))
        if a.shape[0] == 1:
            a = xp.broadcast_to(a, (C,) + a.shape[1:])
        if a.shape[-1] == ext_len:    # already on the extended begin domain
            G_list.append(xp.asarray(a))
        else:
            G_list.append(pad_last(xp.asarray(a)))
    arrays["G_all"] = xp.stack(G_list) if G_list else \
        xp.zeros((0, C, 3, GPAD + n + END_PAD), np.float32)
    arrays["cum_all"] = xp.stack(
        [pad_last(tr.pool[pid]) for pid in cum_ids]) if cum_ids else \
        xp.zeros((0, C, GPAD + n + 1 + END_PAD), np.float32)

    # H factors become scalar columns (class baked in)
    h_cols: Dict[int, int] = {}

    def h_col(pid: int) -> int:
        if pid not in h_cols:
            a = tr.pool[pid]
            if a.shape[0] == 1:
                vals = a[0]
            else:
                vals = U.class_pick(a, cls)
            h_cols[pid] = scol(vals)
        return h_cols[pid]

    # ---- lessD ---------------------------------------------------------
    lessd_s = []
    for li, ls in enumerate(tr.lessd):
        cum = tr.pool[ls.cum_id]      # (C, n+1)
        cumj = U.class_pick(U.sg(cum, 1, n), cls)
        lessd_s.append(LessDStatic(
            state=ls.state, lane=ls.lane, window=ls.window,
            cum_id=cum_map[ls.cum_id], cumj_col=scol(cumj),
            psi_col=scol(U.class_pick(xp.asarray(tr.log_psi)[:, None]
                                      + xp.zeros((1, n)), cls)),
            jsel_col=icol(ls.j_stopsel), jgate_col=icol(ls.j_gate),
            lenvec_key=f"lessd{li}_lenvec"))
        arrays[f"lessd{li}_lenvec"] = ls.lenvec[::-1].copy()
    if tr.lessd:
        arrays["lessd_bvalid_all"] = xp.stack([
            xp.concatenate([xp.zeros(PAD, np.int8),
                            U.astype(ls.b_valid, np.int8),
                            xp.zeros(END_PAD, np.int8)])
            for ls in tr.lessd])
        arrays["lessd_bstop_all"] = xp.stack([
            xp.concatenate([xp.zeros(PAD, np.int8),
                            U.astype(xp.asarray(ls.b_stopflag), np.int8),
                            xp.zeros(END_PAD, np.int8)])
            for ls in tr.lessd])

    # ---- pinned --------------------------------------------------------
    def pinned_static(pi, ps) -> PinnedStatic:
        x_col, x_key = -1, None
        if ps.x_pos is not None:
            x_key = f"pin_x{pi}"
            arrays[x_key], at = _pinned_lists(ps, U.val(cls))
            x_col = icol(at)
        return PinnedStatic(
            state=ps.state, lane=ps.lane,
            score_col=scol(U.class_pick(ps.score, cls)),
            eop_col=icol(ps.eop), x_col=x_col, x_key=x_key)
    pinned_s = tuple(pinned_static(pi, ps)
                     for pi, ps in enumerate(tr.exon_pinned))

    # ---- sparse exon-hint machinery --------------------------------------
    ht = tr.hint_tables
    hw_rows: List[np.ndarray] = []
    hw_ids: Dict[tuple, int] = {}
    xcol_cache: Dict[tuple, int] = {}
    ccol_cache: Dict[tuple, tuple] = {}
    ecol_cache: Dict[tuple, tuple] = {}

    def hw_row(strand, name):
        key = (strand, name)
        if key not in hw_ids:
            hw_ids[key] = len(hw_rows)
            hw_rows.append(np.asarray(ht[strand].wrows[name], np.float32))
        return hw_ids[key]

    def xcol(strand, bo, name):
        # x = j + bo may exceed n-1 for end-truncated exons: cumulative
        # tracks saturate at n-1 (crossing-type tracks are 0 there anyway);
        # x < 0 candidates are gated off upstream, value 0
        key = (strand, bo, name)
        if key not in xcol_cache:
            xr = np.asarray(ht[strand].xrows[name], np.float64)
            xi = pos + bo
            vals = np.where(xi >= 0, xr[np.clip(xi, 0, n - 1)], 0.0)
            xcol_cache[key] = scol(vals)
        return xcol_cache[key]

    def cross_cols(strand, bo):
        key = (strand, bo)
        if key not in ccol_cache:
            t = ht[strand]
            xi = pos + bo
            ok = (xi >= 0) & (xi < n)
            xc = np.clip(xi, 0, n - 1)
            cols = []
            for k in range(t.cross_start.shape[1]):
                si = icol(np.where(ok, t.cross_start[xc, k], -(1 << 30)))
                wi = scol(np.where(ok, t.cross_w[xc, k], 0.0))
                fi = icol(np.where(ok, t.cross_flag[xc, k], 0))
                cols.append((si, wi, fi))
            ccol_cache[key] = tuple(cols)
        return ccol_cache[key]

    def ex_cols(strand, bo):
        key = (strand, bo)
        if key not in ecol_cache:
            t = ht[strand]
            xi = pos + bo
            ok = (xi >= 0) & (xi < n)
            xc = np.clip(xi, 0, n - 1)
            cols = []
            for k in range(t.ex_pos.shape[1]):
                pi = icol(np.where(ok, t.ex_pos[xc, k], -(1 << 30)))
                wi = scol(np.where(ok, t.ex_w[xc, k], 0.0))
                ki = icol(np.where(ok, t.ex_kind[xc, k], 0))
                cols.append((pi, wi, ki))
            ecol_cache[key] = tuple(cols)
        return ecol_cache[key]

    def hint_static(ecs) -> Optional[HintConvStatic]:
        if ht is None or ecs.hint_strand is None:
            return None
        s_, bo = ecs.hint_strand, ecs.hint_bo
        return HintConvStatic(
            ipo=ecs.hint_ipo, aL=ecs.hint_aL, aR=ecs.hint_aR,
            exclass=ecs.hint_exclass,
            w_be_ep=hw_row(s_, "BE_ep"), w_be_cp=hw_row(s_, "BE_cp"),
            w_cntbe_ep=hw_row(s_, "CntBE_ep"),
            w_cntbe_cp=hw_row(s_, "CntBE_cp"),
            w_cr_ep=hw_row(s_, "CR_ep"), w_cr_cp=hw_row(s_, "CR_cp"),
            w_cntcr_ep=hw_row(s_, "CntCR_ep"),
            w_cntcr_cp=hw_row(s_, "CntCR_cp"),
            w_cnte_ep=hw_row(s_, "CntE_ep"), w_cnte_cp=hw_row(s_, "CntE_cp"),
            w_zc=hw_row(s_, "ZC"),
            x_be_ep=xcol(s_, bo, "BE_ep"), x_be_cp=xcol(s_, bo, "BE_cp"),
            x_cntbe_ep=xcol(s_, bo, "CntBE_ep"),
            x_cntbe_cp=xcol(s_, bo, "CntBE_cp"),
            x_c2_ep=xcol(s_, bo, "C2_ep"),
            x_cntc2_ep=xcol(s_, bo, "CntC2_ep"),
            x_cnte_ep=xcol(s_, bo, "CntE_ep"),
            x_cnte_cp=xcol(s_, bo, "CntE_cp"), x_zc=xcol(s_, bo, "ZC"),
            x_tx_ep=xcol(s_, bo, "TX_ep"), x_tx_cp=xcol(s_, bo, "TX_cp"),
            x_txc_ep=xcol(s_, bo, "TXc_ep"), x_txc_cp=xcol(s_, bo, "TXc_cp"),
            cross_cols=cross_cols(s_, bo), ex_cols=ex_cols(s_, bo))

    # ---- convs ---------------------------------------------------------
    convs = []
    for ei, ecs in enumerate(tr.exon_conv):
        win = tr.gold.geom[ST(ecs.etype)].win if ecs.frame_mode else 0
        vs = []
        for vi, var in enumerate(ecs.variants):
            width = var.len_hi - var.len_lo + 1
            if ecs.frame_mode == 0:
                fsel = None
            elif ecs.frame_mode == 1:
                r0 = (win - var.len_hi) % 3
                fsel = tuple(int((r0 + w) % 3) for w in range(width))
            else:
                r0 = (win + var.len_hi) % 3
                fsel = tuple(int((r0 - w) % 3) for w in range(width))
            vs.append(VariantStatic(g_id=g_map[var.g_id],
                                    h_col=h_col(var.h_id),
                                    len_lo=var.len_lo, len_hi=var.len_hi,
                                    width=width, fsel=fsel,
                                    vb_lo=var.vb_lo, vb_hi=var.vb_hi))
            arrays[f"lenvec{ei}_{vi}"] = var.lenvec[::-1].copy()
        # phi(j) and the end gate packed into one int column
        if ecs.phase_sign < 0:
            phi = (ecs.phase_const - pos) % 3
        else:
            phi = (ecs.phase_const + pos) % 3
        convs.append(ConvStatic(
            state=ecs.state, bpl=ecs.bpl, a_off=ecs.a_off, lane=ecs.lane,
            frame_mode=ecs.frame_mode,
            smin_col=icol(ecs.start_min), smax_col=icol(ecs.start_max),
            gate_col=icol(U.astype(ecs.end_gate, np.int32) +
                          (U.astype(phi, np.int32) << 1)),
            variants=tuple(vs), hint=hint_static(ecs)))

    arrays["scalar_table"] = xp.stack(scal_cols, axis=1)    # (n, NSC)
    arrays["int_table"] = xp.stack(int_cols, axis=1)        # (n, NIC)
    arrays["hw_all"] = xp.stack(hw_rows) if hw_rows else \
        xp.zeros((0, GPAD + n + END_PAD), np.float32)
    arrays["n_true"] = np.int32(n)      # overwritten by bucketed callers

    hint_lm = None
    if tr.hint_lm is not None:
        hint_lm = (tr.hint_lm["exonpart"], tr.hint_lm["CDSpart"],
                   tr.hint_lm["exon"], tr.hint_lm["CDS"],
                   tr.hint_lm["local_cp"])
        if "local_ep" in tr.hint_lm:      # the nc model's local malus
            hint_lm += (tr.hint_lm["local_ep"],)
    static = ScanStatic(
        n=n, S=tr.S, NL=tr.n_lanes, C=C, PAD=PAD, GPAD=GPAD,
        NSC=len(scal_cols), NIC=len(int_cols),
        chain=chain_s, fixed=tuple(fixed_s), lessd=tuple(lessd_s),
        pinned=pinned_s, convs=tuple(convs), cls_col=cls_col,
        NHW=len(hw_rows), hint_lm=hint_lm)
    return static, arrays


def needs_general_scan(tracks: DPTracks) -> bool:
    """True for a piece that the 64-state kernel (engine/viterbi.py) cannot
    take and K2 decodes: more than 64 states or lanes, or a convolution
    variant with absolute begin bounds (the UTR states).  The reference
    routes such pieces to its scan engine the same way
    (augustus_tpu/predict.py:168-175)."""
    return tracks.S > 64 or tracks.n_lanes > 64 or any(
        v.vb_lo is not None or v.vb_hi is not None
        for cv in tracks.exon_conv for v in cv.variants)
