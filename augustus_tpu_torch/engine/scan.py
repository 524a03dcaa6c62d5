"""Scalar-table consolidation of the DP tracks (host numpy).

Host copy of `split_tracks` from `augustus_tpu/engine/scan.py`: the per-state
track lists of a DPTracks are consolidated into one (n, NSC) float32 table
and one (n, NIC) int32 table (GC class baked in per position), plus the
G/cum pools and lessD masks.  engine/pack.py turns these into the Viterbi
kernel's planes.  The XLA scan engines of the reference module (the general
Viterbi and the logsumexp forward) are later slices of the port.
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


def split_tracks(tr: DPTracks):
    """(static, arrays) decomposition with scalar-table consolidation."""
    xp = np
    GPAD = tr.gpad
    PAD = GPAD
    C = tr.n_classes
    n = tr.n
    cls = tr.stairs.astype(np.int64)
    pos = U.arange(n)

    # columns are collected contiguously and stacked once at the end:
    # writing them straight into a row-major (n, NSC) buffer looks
    # cheaper but the strided a[:, k] stores are cache-hostile at Mb
    # scale (measured 2x slower than np.stack's blocked transpose)
    scal_cols: List[np.ndarray] = []
    int_cols: List[np.ndarray] = []

    def scol(values: np.ndarray) -> int:
        scal_cols.append(xp.asarray(values).astype(np.float32))
        return len(scal_cols) - 1

    def icol(values: np.ndarray) -> int:
        int_cols.append(xp.asarray(values).astype(np.int32))
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
        np.zeros((0, C, 3, GPAD + n + END_PAD), np.float32)
    arrays["cum_all"] = xp.stack(
        [pad_last(tr.pool[pid]) for pid in cum_ids]) if cum_ids else \
        np.zeros((0, C, GPAD + n + 1 + END_PAD), np.float32)

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
                            ls.b_valid.astype(np.int8),
                            xp.zeros(END_PAD, np.int8)])
            for ls in tr.lessd])
        arrays["lessd_bstop_all"] = xp.stack([
            xp.concatenate([xp.zeros(PAD, np.int8),
                            xp.asarray(ls.b_stopflag).astype(np.int8),
                            xp.zeros(END_PAD, np.int8)])
            for ls in tr.lessd])

    # ---- pinned --------------------------------------------------------
    pinned_s = tuple(PinnedStatic(
        state=ps.state, lane=ps.lane,
        score_col=scol(U.class_pick(ps.score, cls)), eop_col=icol(ps.eop))
        for ps in tr.exon_pinned)

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
            gate_col=icol(ecs.end_gate.astype(np.int32) +
                          (phi.astype(np.int32) << 1)),
            variants=tuple(vs)))

    arrays["scalar_table"] = xp.stack(scal_cols, axis=1)    # (n, NSC)
    arrays["int_table"] = xp.stack(int_cols, axis=1)        # (n, NIC)
    arrays["n_true"] = np.int32(n)      # overwritten by bucketed callers

    static = ScanStatic(
        n=n, S=tr.S, NL=tr.n_lanes, C=C, PAD=PAD, GPAD=GPAD,
        NSC=len(scal_cols), NIC=len(int_cols),
        chain=chain_s, fixed=tuple(fixed_s), lessd=tuple(lessd_s),
        pinned=pinned_s, convs=tuple(convs), cls_col=cls_col)
    return static, arrays
