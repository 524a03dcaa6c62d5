"""Scalar-table consolidation of the DP tracks (numpy, or torch tensors
inside xputil.use_torch).

Counterpart of `split_tracks` from `augustus_tpu/engine/scan.py`: the per-state
track lists of a DPTracks are consolidated into one (n, NSC) float32 table
and one (n, NIC) int32 table (GC class baked in per position), plus the
G/cum pools and lessD masks, and the sparse exon/CDS hint machinery (window
rows `hw_all`, per-position hint columns and the `HintConvStatic` of every
hinted conv, host route only).  engine/pack.py turns these into the
64-state Viterbi kernel's planes.

The general Viterbi K2 reads the split tables as they are: `scan_forward`
launches `csrc/scan.cu` for CUDA tensors and runs `scan_forward_reference`,
the plain PyTorch version (augustus_tpu's `make_scan_fn` as an eager loop),
for CPU tensors; `scan_work` counts its bytes and operations and
`ScanEngine` drives it for one piece and walks the backpointers on the
host.  `_descriptor` and `smem_layout` give the kernel its records and
shared-memory regions; `segment_counts` and `k2_shares` are the kernel's
arithmetic of the band list (which entries each warp walks at a
position), kept here for the CPU tests as the plain version is kept for
the kernel's results.  The port sends a piece to K2 when the 64-state
kernel cannot take it (`needs_general_scan`: the 71-state UTR
architecture).

K5, the logsumexp twin of K2 (augustus_tpu's `make_forward_fn` over the
same tables), gives such a piece its forward table when it is sampled:
`scan_table` launches `csrc/scan_lse.cu` for CUDA tensors and runs
`scan_table_reference` for CPU tensors, `scan_table_work` counts its bytes
and operations, and `ScanForwardEngine` heats the tables of the piece's
ScanEngine and adds the baseline back.
"""

from __future__ import annotations

import ctypes
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


# --------------------------------------------------------------------------
# K2: the general semi-Markov Viterbi over the split tables (any S <= 128)
# --------------------------------------------------------------------------

NEG = np.float32(F32_NEG)
GATE = np.float32(-1.0e29)
MAX_STATES = 128         # states and lanes csrc/scan.cu holds (int8 args)
K2_WARPS = 16            # csrc/scan.cu: one block of 16 warps
MAX_DESC = 12_288        # descriptor ints the kernel holds in shared memory
MAX_SEG = 256            # segments of a position's band list (csrc/scan.cu)
STAGES = 4               # table rows staged in shared memory
SMEM_BYTES = 232_448     # shared memory one block may take on an H100
# a measurement switch: the deep layout (_descriptor) for every piece, to
# hold it against the layout a piece takes by itself
DEEP_ALWAYS = False

# the order of a hint record's window rows and x columns in the descriptor
# (csrc/scan.cu HINT_W / HINT_X)
HINT_W = ("w_be_ep", "w_be_cp", "w_cntbe_ep", "w_cntbe_cp", "w_cr_ep",
          "w_cr_cp", "w_cntcr_ep", "w_cntcr_cp", "w_cnte_ep", "w_cnte_cp",
          "w_zc")
HINT_X = ("x_be_ep", "x_be_cp", "x_cntbe_ep", "x_cntbe_cp", "x_c2_ep",
          "x_cntc2_ep", "x_cnte_ep", "x_cnte_cp", "x_zc", "x_tx_ep",
          "x_tx_cp", "x_txc_ep", "x_txc_cp")


def scan_tensors(arrays: Dict[str, object], device) -> Dict[str, "torch.Tensor"]:
    """split_tracks' arrays as contiguous tensors on `device` (n_true, a
    padding marker of the bucketed reference engines, is dropped)."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(device)
            for k, v in arrays.items() if k != "n_true"}


def _last_max(score):
    """(max, index of its LAST occurrence) of a 1-d tensor (the reference's
    ridx = max(where(score == best, widx, -1)))."""
    flip = score.flip(0)
    i = int(flip.argmax())
    return flip[i], score.shape[0] - 1 - i


def _hint_quot_ref(st: ScanStatic, hs: HintConvStatic, hw, srow, irow, lm,
                   b, widx, len_hi: int):
    """augustus_tpu's scan._hint_quot term for term (float32, same operand
    order) at the begins b of one variant's band; srow: the position's
    scalar row (tensor), irow: its int row (numpy), lm: hint_lm as float32
    tensors, hw: hw_all."""
    import torch
    f32 = torch.float32
    lm_ep, lm_cp, lm_ex, lm_cds, lm_loc = lm[:5]
    nc = hs.exclass == 4
    lm_loc_ep = lm[5] if nc else None
    ipo = hs.ipo
    bob = b - ipo
    c1 = st.GPAD + bob - 1                 # hw_all column of bob - 1
    zero = torch.zeros(b.shape, dtype=f32, device=b.device)
    z0 = torch.zeros((), dtype=f32, device=b.device)

    def WR(row, col):
        return hw[row, col]

    cov_ep, cov_cp = srow[hs.x_tx_ep], srow[hs.x_tx_cp]
    covc_ep, covc_cp = srow[hs.x_txc_ep], srow[hs.x_txc_cp]
    # an empty slot (flag or kind 0) adds and subtracts zeros only: skipped
    for (sc_, wc_, fc_) in hs.cross_cols:
        sk, wk, fl = int(irow[sc_]), srow[wc_], int(irow[fc_])
        if fl == 0:
            continue
        sub = (sk >= bob).to(f32)
        cov_ep = cov_ep - (wk if fl == 1 else z0) * sub
        covc_ep = covc_ep - (1.0 if fl == 1 else 0.0) * sub
        cov_cp = cov_cp - (wk if fl == 2 else z0) * sub
        covc_cp = covc_cp - (1.0 if fl == 2 else 0.0) * sub
    crw_ep = WR(hs.w_cr_ep, c1 + 1)
    inside_ep = ((srow[hs.x_be_ep] - WR(hs.w_be_ep, c1)) - crw_ep) + cov_ep
    inside_cp = ((srow[hs.x_be_cp] - WR(hs.w_be_cp, c1))
                 - WR(hs.w_cr_cp, c1 + 1)) + cov_cp
    ccw_ep = WR(hs.w_cntcr_ep, c1 + 1)
    cin_ep = ((srow[hs.x_cntbe_ep] - WR(hs.w_cntbe_ep, c1)) - ccw_ep) \
        + covc_ep
    cin_cp = ((srow[hs.x_cntbe_cp] - WR(hs.w_cntbe_cp, c1))
              - WR(hs.w_cntcr_cp, c1 + 1)) + covc_cp
    part_bonus = inside_ep + inside_cp
    nep = cin_ep + cin_cp
    if hs.aL:
        part_bonus = part_bonus + 0.5 * (crw_ep - cov_ep)
        nep = nep + (ccw_ep - covc_ep)
    if hs.aR:
        part_bonus = part_bonus + 0.5 * (srow[hs.x_c2_ep] - cov_ep)
        nep = nep + (srow[hs.x_cntc2_ep] - covc_ep)
    quot = part_bonus
    sup_ex, sup_cds = zero, zero
    for (pc_, wc_, kc_) in hs.ex_cols:
        pk, wk, kd = int(irow[pc_]), srow[wc_], int(irow[kc_])
        if kd == 0:
            continue
        cond = ((bob == pk) & (kd == 1)).to(f32)
        quot = quot + wk * cond
        sup_cds = torch.maximum(sup_cds, cond)
        if hs.exclass in (1, 4):
            cond = ((bob == pk) & (kd == 2)).to(f32)
            quot = quot + wk * cond
            sup_ex = torch.maximum(sup_ex, cond)
        elif hs.exclass == 3:
            cond = ((pk < bob) & (kd == 3) & (pk > -(1 << 29))).to(f32)
            quot = quot + (0.5 * wk) * cond
            sup_ex = torch.maximum(sup_ex, cond)
    if hs.exclass == 2:
        for (sc_, wc_, fc_) in hs.cross_cols:
            sk, wk, fl = int(irow[sc_]), srow[wc_], int(irow[fc_])
            if fl != 4:
                continue
            cond = ((bob == sk) & (fl == 4)).to(f32)
            quot = quot + (0.5 * wk) * cond
            sup_ex = torch.maximum(sup_ex, cond)
    quot = quot + lm_ex * (1.0 - sup_ex)
    if not nc:
        quot = quot + lm_cds * (1.0 - sup_cds)
    lenv = torch.tensor(np.float32(len_hi), device=b.device) - widx.to(f32)
    d_ep = lenv - (srow[hs.x_cnte_ep] - WR(hs.w_cnte_ep, c1))
    quot = quot + torch.where(d_ep > 0, d_ep * lm_ep, zero)
    if not nc:
        d_cp = lenv - (srow[hs.x_cnte_cp] - WR(hs.w_cnte_cp, c1))
        quot = quot + torch.where(d_cp > 0, d_cp * lm_cp, zero)
    zc = srow[hs.x_zc] - WR(hs.w_zc, c1)
    if nc:
        # the nc model's local malus: exonpart's, from one hint inside on
        # (gold_nc._not_end_part; none when that malus is 1)
        if float(lm_loc_ep) == 0.0:
            return quot
        lpm = torch.where(zc > 0, zc * lm_loc_ep, zero)
        lpm = torch.maximum(lpm, -part_bonus)
        return quot + torch.where(nep >= 0.5, lpm, zero)
    lpm = torch.where(zc > 0, zc * lm_loc, zero)
    lpm = torch.maximum(lpm, -part_bonus)
    return quot + torch.where(nep >= 4.5, lpm, zero)


class _Plain:
    """What the plain versions of K2 and K5 read, gathered once per piece:
    the tables `t`, the int table on the host, constants as tensors, and the
    index tensors of the chain, fixed and pinned states, of the lessD windows
    (in groups of one width) and of the convolution variants."""

    def __init__(self, st: ScanStatic, t: Dict[str, "torch.Tensor"]):
        import torch
        i64 = torch.int64
        self.st, self.t = st, t
        self.stab = t["scalar_table"]
        dev = self.dev = self.stab.device
        self.itab = t["int_table"].cpu().numpy()
        self.itab_t = t["int_table"].to(i64)
        self.NEGt = torch.tensor(NEG, dtype=torch.float32, device=dev)
        self.GATEt = torch.tensor(GATE, dtype=torch.float32, device=dev)
        self.lm = None if st.hint_lm is None else [
            torch.tensor(np.float32(x), device=dev) for x in st.hint_lm]

        def T(x, dt=i64):
            return torch.tensor(x, dtype=dt, device=dev)
        self.ch_s = T([c.state for c in st.chain])
        self.ch_emi = T([c.emi_col for c in st.chain])
        fx = st.fixed
        self.fx_s = T([f.state for f in fx])
        self.fx_l = T([f.lane for f in fx])
        self.fx_l2 = T([f.lane + 1 if f.kind == 2 else f.lane for f in fx])
        self.fx_D = T([f.jump for f in fx])
        self.fx_emi = T([f.emi_col for f in fx])
        self.fx_x = T([max(f.extra_col, 0) for f in fx])
        self.fx_k1 = T([f.kind == 1 for f in fx], torch.bool)
        self.fx_k2 = T([f.kind == 2 for f in fx], torch.bool)
        pn = st.pinned
        self.pn_s = T([p.state for p in pn])
        self.pn_l = T([p.lane for p in pn])
        self.pn_sc = T([p.score_col for p in pn])
        self.pn_eop = T([p.eop_col for p in pn])
        self.pn_x = [(pi, p, t[p.x_key].cpu().numpy())
                     for pi, p in enumerate(pn) if p.x_col >= 0]
        groups = {}
        for li, d in enumerate(st.lessd):
            groups.setdefault(d.window, []).append((li, d))
        self.lessd = [(
            W, T([li for li, _ in g]), T([d.state for _, d in g]),
            T([d.lane for _, d in g]), T([d.cum_id for _, d in g]),
            T([d.cumj_col for _, d in g]), T([d.psi_col for _, d in g]),
            T([d.jsel_col for _, d in g]), T([d.jgate_col for _, d in g]),
            torch.stack([t[d.lenvec_key] for _, d in g]),
            torch.arange(W, device=dev)) for W, g in groups.items()]
        self.convs = [(cv, [(v, t[f"lenvec{ei}_{vi}"],
                             None if v.fsel is None else cv.lane +
                             T(list(v.fsel)),
                             torch.arange(v.width, device=dev))
                            for vi, v in enumerate(cv.variants)])
                      for ei, cv in enumerate(st.convs)]

    def pinned_more(self, irow):
        """The further candidates of the pinned states at a position:
        [(state, lane, [(eop, score as a float32 tensor), ...])]."""
        import torch
        out = []
        for _, p, lst in self.pn_x:
            x = int(irow[p.x_col])
            if x < 0:
                continue
            cnt = int(lst[x])
            out.append((p.state, p.lane, [
                (int(lst[x + 1 + 2 * k]),
                 torch.tensor(lst[x + 2 + 2 * k], device=self.dev))
                for k in range(cnt)]))
        return out

    def lessd_score(self, group, lanes, j: int, c: int, srow, irow_t):
        """The scores (windows, W) of one group of lessD windows at j, and
        the lanes column of their entry 0."""
        import torch
        st, t = self.st, self.t
        W, li, _, ll, lcum, lcj, lpsi, ljs, _, lvd, widx = group
        c0 = j - W + st.PAD
        lsl = lanes[ll, c0: c0 + W]
        csl = t["cum_all"][lcum, c, j - W + st.GPAD + 1: j + st.GPAD + 1]
        seg = srow[lcj][:, None] - csl
        bval = t["lessd_bvalid_all"][li, c0: c0 + W]
        bst = t["lessd_bstop_all"][li, c0: c0 + W]
        stop = (bst & irow_t[ljs].to(torch.int8)[:, None]) != 0
        ok = (widx >= W - j)[None, :] & (bval != 0) & ~stop
        return torch.where(ok & (lsl > self.GATEt),
                           ((lsl + seg) + lvd) + srow[lpsi][:, None],
                           self.NEGt), c0

    def band(self, cv, variant, lanes, j: int, c: int, phi: int, smin: int,
             smax: int, srow, irow):
        """The scores of a convolution variant at j over its begins inside
        [smin, smax] (and vb_lo / vb_hi), the entry w0 of the first and the
        lanes column e0 of entry 0; None when no begin is inside.  The
        reference scores the other begins NEG, which neither a last maximum
        nor a logsumexp can take from the band's value (csrc/scan.cu says
        why)."""
        import torch
        st = self.st
        var, lvd, lrow, widx = variant
        b0 = j + cv.a_off - var.len_hi
        lo, hi = smin, smax
        if var.vb_lo is not None:
            lo = max(lo, var.vb_lo)
        if var.vb_hi is not None:
            hi = min(hi, var.vb_hi)
        w0, w1 = max(0, lo - b0), min(var.width - 1, hi - b0) + 1
        if w1 <= w0:
            return None
        e0 = b0 - cv.bpl - 1 + st.PAD           # lanes column of w = 0
        G = self.t["G_all"][var.g_id, c, phi,
                            st.GPAD + b0 + w0: st.GPAD + b0 + w1]
        if lrow is None:
            L = lanes[cv.lane, e0 + w0: e0 + w1]
        else:
            L = lanes[lrow[w0: w1], e0 + widx[w0: w1]]
        base = (L + G) + lvd[w0: w1]
        if cv.hint is not None:
            base = base + _hint_quot_ref(
                st, cv.hint, self.t["hw_all"], srow, irow, self.lm,
                b0 + widx[w0: w1], widx[w0: w1], var.len_hi)
        return (torch.where((L > self.GATEt) & (G > self.GATEt), base,
                            self.NEGt), w0, e0)


def scan_forward_reference(st: ScanStatic, t: Dict[str, "torch.Tensor"],
                           v0: "torch.Tensor", debug_vals: bool = False):
    """The plain PyTorch version of K2: augustus_tpu's
    `scan.make_scan_fn(debug_vals=True)` as an eager loop over positions
    j = 1 .. n-1 (float32, the same operand order and tie rules).  Gates,
    classes and band bounds are read on the host from the int table; all
    float arithmetic runs in torch on the tables' device.  A convolution
    band is scored only over its begins inside [smin, smax] (and vb_lo /
    vb_hi), as csrc/scan.cu clips it; exact, since the reference scores the
    others NEG (csrc/scan.cu says why).

    Returns (bp (n, S) int32, v_final (S,) float32, vals (n, S) float32 or
    None): row j of bp and vals belongs to base j (the reference's
    bps[j - 1]); row 0 of bp is 0, of vals v0."""
    import torch
    n, S, NL, PAD = st.n, st.S, st.NL, st.PAD
    f32, i64 = torch.float32, torch.int64
    P = _Plain(st, t)
    dev, NEGt, GATEt = P.dev, P.NEGt, P.GATEt
    ltr, lane_tr = t["log_trans"], t["lane_trans"]

    LW = n + PAD + END_PAD
    lanes = torch.full((NL, LW), NEG, dtype=f32, device=dev)
    largs = torch.zeros((NL, LW), dtype=i64, device=dev)
    v0 = v0.to(dev, f32)
    cand0 = v0[None, :] + lane_tr
    lanes[:, : PAD + 1] = cand0.max(dim=1).values[:, None]
    largs[:, : PAD + 1] = torch.argmax(cand0, dim=1)[:, None]

    bp = torch.zeros((n, S), dtype=torch.int32, device=dev)
    vals_out = torch.full((n, S), NEG, dtype=f32, device=dev) \
        if debug_vals else None
    if debug_vals:
        vals_out[0] = v0

    vprev = v0.clone()
    for j in range(1, n):
        irow = P.itab[j]
        irow_t = P.itab_t[j]
        c = int(irow[st.cls_col])
        srow = P.stab[j]
        vals = torch.full((S,), NEG, dtype=f32, device=dev)
        bps = torch.zeros(S, dtype=i64, device=dev)

        # chain states: first argmax over the predecessors
        if st.chain:
            cand = vprev[:, None] + ltr[c][:, P.ch_s]
            arg = torch.argmax(cand, dim=0)
            best = torch.gather(cand, 0, arg[None, :])[0]
            vals[P.ch_s] = torch.where(best > GATEt, best + srow[P.ch_emi],
                                       NEGt)
            bps[P.ch_s] = (arg << 20) | 1

        # fixed-jump states
        if st.fixed:
            col = PAD - P.fx_D + j
            A, Aa = lanes[P.fx_l, col], largs[P.fx_l, col]
            X = srow[P.fx_x]
            B = lanes[P.fx_l2, col] + X
            lv = torch.where(P.fx_k1, A + X,
                             torch.where(P.fx_k2, torch.maximum(A, B), A))
            la = torch.where(P.fx_k2 & (B > A), largs[P.fx_l2, col], Aa)
            emi = srow[P.fx_emi]
            ok = (P.fx_D <= j) & (lv > GATEt) & (emi > GATEt)
            vals[P.fx_s] = torch.where(ok, lv + emi, NEGt)
            bps[P.fx_s] = (la << 20) | P.fx_D

        # lessD: last argmax over the window's ends of the previous segment
        for g in P.lessd:
            W, ls, ll, ljg = g[0], g[2], g[3], g[8]
            score, c0 = P.lessd_score(g, lanes, j, c, srow, irow_t)
            flip = score.flip(1)
            ridx = W - 1 - torch.argmax(flip, dim=1)
            best = torch.gather(score, 1, ridx[:, None])[:, 0]
            gated = (irow_t[ljg] != 0) & (best > GATEt)
            vals[ls] = torch.where(gated, best, NEGt)
            bps[ls] = (largs[ll, c0 + ridx] << 20) | (W - ridx)

        # pinned states: a far-back candidate; where a position has
        # several, the last maximum of the live ones in candidate order
        if st.pinned:
            eop = irow_t[P.pn_eop]
            row = torch.clamp(eop, min=-PAD) + PAD
            lv, la = lanes[P.pn_l, row], largs[P.pn_l, row]
            sc = srow[P.pn_sc]
            ok = (sc > GATEt) & (lv > GATEt)
            vals[P.pn_s] = torch.where(ok, lv + sc, NEGt)
            bps[P.pn_s] = (la << 20) | (j - eop)
            for s, lane, more in P.pinned_more(irow):
                for e, sc in more:
                    r = max(e, -PAD) + PAD
                    lv = lanes[lane, r]
                    v = lv + sc
                    if bool(sc > GATEt) and bool(lv > GATEt) and \
                            bool(v >= vals[s]):
                        vals[s] = v
                        bps[s] = (largs[lane, r] << 20) | (j - e)

        # exon and UTR convolutions, skipped where the end gate is off
        for cv, variants in P.convs:
            gp = int(irow[cv.gate_col])
            if not gp & 1:
                bps[cv.state] = 1
                continue
            smin, smax = int(irow[cv.smin_col]), int(irow[cv.smax_col])
            best, bpred, boff = NEGt, 0, 1
            for variant in variants:
                got = P.band(cv, variant, lanes, j, c, gp >> 1, smin, smax,
                             srow, irow)
                if got is None:
                    continue
                score, w0, e0 = got
                var, lrow = variant[0], variant[2]
                sbest, ridx = _last_max(score)
                H = srow[var.h_col]
                if bool(sbest > GATEt) and bool(H > GATEt):
                    vbest = sbest + H
                    if bool(vbest > best):
                        best = vbest
                        w = w0 + ridx
                        r = cv.lane if lrow is None else int(lrow[w])
                        bpred = int(largs[r, e0 + w])
                        boff = (var.len_hi - cv.a_off + cv.bpl + 1) - w
            vals[cv.state] = best
            bps[cv.state] = (bpred << 20) | boff

        bp[j] = bps.to(torch.int32)
        if debug_vals:
            vals_out[j] = vals
        cand = vals[None, :] + lane_tr
        lanes[:, j + PAD] = cand.max(dim=1).values
        largs[:, j + PAD] = torch.argmax(cand, dim=1)
        vprev = vals
    return bp, vprev, vals_out


def scan_table_reference(st: ScanStatic, t: Dict[str, "torch.Tensor"],
                         v0: "torch.Tensor"):
    """The plain PyTorch version of K5: augustus_tpu's
    `scan.make_forward_fn` as an eager loop over positions j = 1 .. n-1
    (float32, the same operations: `lse_vec` and `lse2` as
    engine/forward.py:_lse computes them, the score ((L + G) + lenvec)
    [+ quot] and + H, the lane update a logsumexp over S).  It reads the
    tables of scan_forward_reference and clips the bands as it does: exact
    for a logsumexp too, since a clipped entry is NEG and adds nothing, and
    when no entry passes GATE the value is NEG either way.

    Returns (rows (n, S) float32, row j the values of base j and row 0 v0;
    the count of exp and log evaluations over live candidates)."""
    import torch
    from .forward import _lse, _lse2
    n, S, NL, PAD = st.n, st.S, st.NL, st.PAD
    f32 = torch.float32
    P = _Plain(st, t)
    dev, NEGt, GATEt = P.dev, P.NEGt, P.GATEt
    ltr, lane_tr = t["log_trans"], t["lane_trans"]
    fx_i2 = P.fx_k2.nonzero()[:, 0]

    lanes = torch.full((NL, n + PAD + END_PAD), NEG, dtype=f32, device=dev)
    v0 = v0.to(dev, f32)
    l0, sfu = _lse(v0[None, :] + lane_tr, 1)
    lanes[:, : PAD + 1] = l0[:, None]
    rows = torch.full((n, S), NEG, dtype=f32, device=dev)
    rows[0] = v0

    vprev = v0
    for j in range(1, n):
        irow = P.itab[j]
        irow_t = P.itab_t[j]
        c = int(irow[st.cls_col])
        srow = P.stab[j]
        vals = torch.full((S,), NEG, dtype=f32, device=dev)

        # chain states: a logsumexp over the predecessors
        if st.chain:
            best, k = _lse(vprev[:, None] + ltr[c][:, P.ch_s], 0)
            sfu += k
            vals[P.ch_s] = torch.where(best > GATEt, best + srow[P.ch_emi],
                                       NEGt)

        # fixed-jump states (kind 2: lse2 of its two lanes)
        if st.fixed:
            col = PAD - P.fx_D + j
            A = lanes[P.fx_l, col]
            X = srow[P.fx_x]
            lv = torch.where(P.fx_k1, A + X, A)
            if fx_i2.numel():
                lv[fx_i2], k = _lse2(A[fx_i2], lanes[P.fx_l2[fx_i2],
                                                     col[fx_i2]] + X[fx_i2])
                sfu += k
            emi = srow[P.fx_emi]
            ok = (P.fx_D <= j) & (lv > GATEt) & (emi > GATEt)
            vals[P.fx_s] = torch.where(ok, lv + emi, NEGt)

        # lessD: a logsumexp over the window's ends of the previous segment
        for g in P.lessd:
            best, k = _lse(P.lessd_score(g, lanes, j, c, srow, irow_t)[0], 1)
            sfu += k
            gated = (irow_t[g[8]] != 0) & (best > GATEt)
            vals[g[2]] = torch.where(gated, best, NEGt)

        # pinned states: a far-back candidate; where a position has
        # several, lse2 of the live ones in candidate order
        if st.pinned:
            eop = irow_t[P.pn_eop]
            lv = lanes[P.pn_l, torch.clamp(eop, min=-PAD) + PAD]
            sc = srow[P.pn_sc]
            vals[P.pn_s] = torch.where((sc > GATEt) & (lv > GATEt), lv + sc,
                                       NEGt)
            for s, lane, more in P.pinned_more(irow):
                for e, sc in more:
                    lv = lanes[lane, max(e, -PAD) + PAD]
                    v = torch.where((sc > GATEt) & (lv > GATEt), lv + sc,
                                    NEGt)
                    vals[s], k = _lse2(vals[s], v)
                    sfu += k

        # exon and UTR convolutions: per variant a logsumexp over its
        # clipped band, then lse2 into the state's value in variant order
        for cv, variants in P.convs:
            gp = int(irow[cv.gate_col])
            if not gp & 1:
                continue
            smin, smax = int(irow[cv.smin_col]), int(irow[cv.smax_col])
            best = NEGt
            for variant in variants:
                got = P.band(cv, variant, lanes, j, c, gp >> 1, smin, smax,
                             srow, irow)
                if got is None:
                    continue
                sbest, k = _lse(got[0])
                H = srow[variant[0].h_col]
                vbest = torch.where((sbest > GATEt) & (H > GATEt), sbest + H,
                                    NEGt)
                best, k2 = _lse2(best, vbest)
                sfu += k + k2
            vals[cv.state] = best

        rows[j] = vals
        lanes[:, j + PAD], k = _lse(vals[None, :] + lane_tr, 1)
        sfu += k
        vprev = vals
    return rows, int(sfu)


# --------------------------------------------------------------------------
# the kernel's descriptor, the wrapper, the work count and the engine
# --------------------------------------------------------------------------

D_HEADER = 56
# header fields after the layout (csrc/k2_common.cuh D_SHARE .. D_BYTES)
D_SHARE_AT, D_NSS_AT, D_NIS_AT, D_DEEP_AT, D_BYTES_AT = range(39, 44)
T_CHAIN, T_FIXED, T_LESSD, T_PINNED, T_CONV = range(5)
VR_SIZE = 11             # ints of a variant record
HR_SLOTS = 30            # a hint record's field of its slot lists' offset
# the shared-memory regions of csrc/scan.cu after the descriptor, in this
# order (header fields D_SM_LT .. D_SM_SCRATCH, in 4-byte words)
SMEM_REGIONS = ("lt", "ltc", "stage", "vbuf", "bpbuf", "segoff", "segw0",
                "segwf", "res", "edge", "fp", "segbase", "scratch")
MAXP = 8                 # segments of a chunk of a warp's share
# a segment record (csrc/scan.cu SG_REC .. SG_OFFB): record offset,
# variant (-1: lessD), gate / smin / smax columns, a_off - len_hi, vb_lo,
# vb_hi, width, G row, length vector offset, r0, frame mode, lane, lanes
# column of entry 0 less j, hint record, H column, len_hi - a_off + bpl + 1
SG_SIZE = 18
N_LM = 6                 # hint maluses at the head of the float table
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1


def smem_layout(st: ScanStatic, desc_len: int,
                staged: Optional[int] = None) -> Dict[str, int]:
    """Word offsets of csrc/scan.cu's shared-memory regions, the staged
    row width `rw` (of `staged` columns, all NSC + NIC by default) and the
    total `bytes`: the descriptor's first desc_len ints, lane_trans (NL,
    S) and the chain states' log_trans columns (C, chain, S) in rows of S
    padded to a multiple of 16, STAGES table rows, values and backpointers
    of two positions, the segment offsets and clipped starts of two
    positions, the first and last warps of each segment, the
    segments' results, the warps' FIRST / LAST pieces, the lane history
    words of the fixed and pinned states, the segments' band bases of two
    positions and each warp's parked lane partials."""
    def up4(x):
        return (x + 3) // 4 * 4
    rw = up4(st.NSC + st.NIC if staged is None else staged)
    sp = (st.S + 15) // 16 * 16        # S padded, the rows of lt and ltc
    sizes = {"lt": st.NL * sp, "ltc": st.C * len(st.chain) * sp,
             "stage": STAGES * rw, "vbuf": 2 * MAX_STATES,
             "bpbuf": 2 * MAX_STATES, "segoff": 2 * (MAX_SEG + 1),
             "segw0": 2 * MAX_SEG, "segwf": 2 * MAX_SEG, "res": 3 * MAX_SEG,
             "edge": 3 * 2 * K2_WARPS, "fp": 4 * MAX_STATES,
             "segbase": 2 * 2 * MAX_SEG, "scratch": K2_WARPS * 3 * MAXP * 32}
    out, at = {}, up4(desc_len)
    for k in SMEM_REGIONS:
        out[k] = at
        at = up4(at + sizes[k])
    out["rw"] = rw
    out["words"] = at
    out["bytes"] = at * 4
    return out


def segments(st: ScanStatic) -> List[Tuple[int, int]]:
    """The band list's segments of every position, in the kernel's order:
    (conv index, variant) for each variant of each convolution, then
    (lessD index, -1) for each lessD window."""
    return [(ci, vi) for ci, cv in enumerate(st.convs)
            for vi in range(len(cv.variants))] + \
        [(li, -1) for li in range(len(st.lessd))]


def segment_counts(st: ScanStatic, irow, j: int):
    """(counts, clipped starts) of the segments at position j, as csrc/
    scan.cu's warps 12-15 compute them from the int table row `irow`: a gated
    variant's begins inside [smin, smax] (and vb_lo / vb_hi), none where
    its end gate is off; a lessD window's W entries."""
    cnt, w0s = [], []
    for ci, vi in segments(st):
        if vi < 0:
            cnt.append(st.lessd[ci].window)
            w0s.append(0)
            continue
        cv = st.convs[ci]
        v = cv.variants[vi]
        c, w0 = 0, 0
        if int(irow[cv.gate_col]) & 1:
            b0 = j + cv.a_off - v.len_hi
            lo, hi = int(irow[cv.smin_col]), int(irow[cv.smax_col])
            if v.vb_lo is not None:
                lo = max(lo, v.vb_lo)
            if v.vb_hi is not None:
                hi = min(hi, v.vb_hi)
            w0 = max(0, lo - b0)
            c = max(0, min(v.width - 1, hi - b0) - w0 + 1)
        cnt.append(c)
        w0s.append(w0)
    return cnt, w0s


def k2_shares(st: ScanStatic, irow, j: int):
    """The shares of csrc/scan.cu's phase A at position j: for each warp w,
    the list of (segment, first entry w, last entry w) it walks, from
    entries [T w / 16, T (w + 1) / 16) of the T in the band list."""
    cnt, w0s = segment_counts(st, irow, j)
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    T = int(off[-1])
    out = []
    for w in range(K2_WARPS):
        s0, s1 = T * w // K2_WARPS, T * (w + 1) // K2_WARPS
        share = []
        # the first segment whose end passes s0, as the kernel's search
        q = int(np.searchsorted(off[1:], s0, side="right"))
        while s1 > s0 and q < len(cnt) and off[q] < s1:
            i0, i1 = max(s0, int(off[q])), min(s1, int(off[q + 1]))
            if i1 > i0:
                share.append((q, w0s[q] + i0 - int(off[q]),
                              w0s[q] + i1 - int(off[q]) - 1))
            q += 1
        out.append(share)
    return out


# K5's combine shapes (csrc/scan_lse.cu), in float32 numpy, for the CPU
# tests of their order: a pair (m, s) stands for m + log(s); the empty pair
# is (-inf, 0), and m is -inf or live (> GATE).
BATCH = 4                # band entries a lane loads at once (k2_common.cuh)
MERGE_G = 4              # lanes per segment in merge_parked
RED_G = 4                # lanes per lane / chain state in phase C
COMB_G = 8               # lanes per conv state in phase B
_NINF = np.float32(-np.inf)


def _exp(x):
    return np.exp(np.float32(x), dtype=np.float32)


def _tree_sum(x):
    """The kernel's tree_sum: pairwise, neighbours first."""
    x = [np.float32(v) for v in x]
    w = 1
    while w < len(x):
        for i in range(0, len(x) - w, 2 * w):
            x[i] = np.float32(x[i] + x[i + w])
        w *= 2
    return x[0]


def _group_sum(parts):
    """The xor shuffles of adds over a group of lanes (offsets 1, 2, ...):
    lane 0's bits, which every lane of the group gets."""
    s = [np.float32(v) for v in parts]
    o = 1
    while o < len(s):
        s = [np.float32(s[i] + s[i ^ o]) for i in range(len(s))]
        o *= 2
    return s[0]


def lse_value_ref(m, s):
    return np.float32(m + np.log(np.float32(s), dtype=np.float32)) \
        if m > GATE else NEG


def lse_batch_ref(m, s, x):
    """A lane's pair (m, s) after one batch of BATCH scores x (NEG past
    the run): the batch's maximum, s rescaled at most once, the batch's
    terms in tree_sum."""
    x = np.asarray(x, np.float32)
    bm = x.max()
    if not bm > GATE:
        return m, s
    nm = max(m, bm)
    r = _exp(m - nm) if m < nm else np.float32(1.0)
    e = [_exp(v - nm) if v > GATE else np.float32(0.0) for v in x]
    return nm, np.float32(np.float32(s * r) + _tree_sum(e))


def run_pair_ref(scores):
    """A lane's run: its scores in batches of BATCH, from the empty pair."""
    m, s = _NINF, np.float32(0.0)
    scores = np.asarray(scores, np.float32)
    for b in range(0, len(scores), BATCH):
        x = np.full(BATCH, NEG, np.float32)
        x[: len(scores) - b] = scores[b: b + BATCH]
        m, s = lse_batch_ref(m, s, x)
    return m, s


def merge_parked_ref(pm, ps):
    """A segment's 32 parked pairs (lane l's at l) merged by a group of
    MERGE_G lanes, lane c pairs 8 c .. 8 c + 7: the exact maximum, one
    term per pair, each lane's tree_sum, the group's xor tree."""
    pm = np.asarray(pm, np.float32)
    ps = np.asarray(ps, np.float32)
    M = pm.max()
    k = 32 // MERGE_G
    parts = [_tree_sum([ps[i] * _exp(pm[i] - M) if pm[i] > GATE
                        else np.float32(0.0) for i in range(c * k, c * k + k)])
             for c in range(MERGE_G)]
    return M, _group_sum(parts)


def share_piece_ref(scores, lane0=0):
    """The pair of one warp's piece of a segment: entry e of the piece on
    lane (lane0 + e) % 32 (lane0: the piece's first entry less the chunk's
    first), each lane's entries as one run, then merge_parked."""
    scores = np.asarray(scores, np.float32)
    pairs = [run_pair_ref(scores[(l - lane0) % 32::32]) for l in range(32)]
    return merge_parked_ref([p[0] for p in pairs], [p[1] for p in pairs])


def seg_value_ref(pm, ps):
    """A cut segment's value from its pieces in ascending share order: the
    maximum, then each piece's term added in order, then M + log(S)."""
    M = np.max(np.asarray(pm, np.float32))
    if not M > GATE:
        return NEG
    s = np.float32(0.0)
    for i, (m, v) in enumerate(zip(pm, ps)):
        t = np.float32(np.float32(v) * _exp(np.float32(m) - M))
        s = t if i == 0 else np.float32(s + t)
    return np.float32(M + np.log(s, dtype=np.float32))


def fold_variants_ref(vals):
    """A conv state's value from its variants' values (in variant order) on
    COMB_G lanes: lane k variants k, k + 8, ..., the group's maximum, each
    lane's terms in order, the group's xor tree of adds."""
    vals = np.asarray(vals, np.float32)
    M = vals.max(initial=_NINF)
    if not M > GATE:
        return NEG
    parts = []
    for k in range(COMB_G):
        s = np.float32(0.0)
        for v in vals[k::COMB_G]:
            s = np.float32(s + (_exp(v - M) if v > GATE else np.float32(0)))
        parts.append(s)
    return lse_value_ref(M, _group_sum(parts))


def reduce_c_ref(cands):
    """Phase C's logsumexp over one item's candidates (S of them, padded
    with -inf to a multiple of 16): RED_G lanes a contiguous quarter each,
    the group's maximum, each lane's live terms added in state order, the
    group's xor tree of adds."""
    c = np.asarray(cands, np.float32)
    c = np.concatenate([c, np.full(-len(c) % 16, _NINF, np.float32)])
    M = c.max()
    ch = len(c) // RED_G
    parts = []
    for k in range(RED_G):
        s = np.float32(0.0)
        for v in c[k * ch: (k + 1) * ch]:
            if v > GATE:
                s = np.float32(s + _exp(v - M))
        parts.append(s)
    return lse_value_ref(M, _group_sum(parts))


def check_limits(st: ScanStatic) -> None:
    """Raise NotImplementedError, on every device, for a piece beyond what
    csrc/scan.cu holds: more than MAX_STATES states or lanes (the lane args
    are int8, as in the reference), more than MAX_SEG band segments."""
    if st.S > MAX_STATES or st.NL > MAX_STATES:
        raise NotImplementedError(
            f"{st.S} states and {st.NL} lanes: the general Viterbi kernel "
            f"takes at most {MAX_STATES} of each")
    nseg = len(segments(st))
    if nseg > MAX_SEG:
        raise NotImplementedError(
            f"{nseg} convolution variants and lessD windows: the general "
            f"Viterbi kernel takes at most {MAX_SEG}")


def slot_columns(st: ScanStatic) -> Tuple[List[int], List[int]]:
    """The scalar and int columns of the hint slots (every crossing and
    exact-match slot of every hinted conv), ascending: the columns a deep
    piece's kernel reads from global memory, not from its staged rows."""
    sc, ic = set(), set()
    for cv in st.convs:
        if cv.hint is not None:
            for a, b, c in tuple(cv.hint.cross_cols) + tuple(cv.hint.ex_cols):
                ic.update((a, c))
                sc.add(b)
    return sorted(sc), sorted(ic)


def deep_perms(st: ScanStatic):
    """(scalar, int) column orders of a deep piece's kernel tables: the
    columns that are no hint slot, then the slot columns, each ascending."""
    ss, si = slot_columns(st)
    s_set, i_set = set(ss), set(si)
    return ([c for c in range(st.NSC) if c not in s_set] + ss,
            [c for c in range(st.NIC) if c not in i_set] + si)


def _descriptor(st: ScanStatic, t: Dict[str, object]):
    """(int32 descriptor, float32 table) of csrc/scan.cu: the header, one
    task word (kind << 24 | record offset) per state, the records of the
    states, variants, hint records and segments, then the hint records'
    slot lists (one per distinct list); the floats hold hint_lm, every
    length vector (reversed, as split_tracks stores them) and the pinned
    states' further candidates.

    A piece whose descriptor or staged rows would not fit the kernel's
    shared memory (hint slots stacked deep) takes the deep layout (header
    D_DEEP): the slot lists stay in global memory (the kernel copies the
    first D_SHARE ints), the kernel's tables are column-permuted copies
    (deep_perms) whose staged rows hold only the D_NSS / D_NIS columns
    that are no hint slot, and the slots are read from the global rows."""
    desc, floats = _descriptor_of(st, t, False)
    # the normal layout only where a batched launch's block holds it too
    if DEEP_ALWAYS or desc[D_SHARE_AT] > MAX_DESC or \
            desc[D_BYTES_AT] > SMEM_BYTES - BATCH_RECORD_BYTES:
        desc, floats = _descriptor_of(st, t, True)
    if desc[D_SHARE_AT] > MAX_DESC:
        raise NotImplementedError(
            f"a descriptor of {desc[D_SHARE_AT]} ints before its slot lists "
            f"(the general Viterbi kernel holds {MAX_DESC})")
    if desc[D_BYTES_AT] > SMEM_BYTES:
        raise NotImplementedError(
            f"{desc[D_BYTES_AT]} bytes of shared memory (the general "
            f"Viterbi kernel's block may take {SMEM_BYTES})")
    return desc, floats


def _descriptor_of(st: ScanStatic, t: Dict[str, object], deep: bool):
    """_descriptor's arrays in the normal or the deep layout."""
    n = st.n
    ints: List[int] = [0] * D_HEADER
    lm = tuple(st.hint_lm or ())
    floats: List[np.ndarray] = [np.asarray(
        lm + (0.0,) * (N_LM - len(lm)), np.float32)]
    nfl = [N_LM]
    if deep:
        ps, pi = deep_perms(st)
        smap = np.empty(st.NSC, np.int64)
        smap[ps] = np.arange(st.NSC)
        imap = np.empty(st.NIC, np.int64)
        imap[pi] = np.arange(st.NIC)
        ss, si = slot_columns(st)
        nss, nis = st.NSC - len(ss), st.NIC - len(si)
    else:
        smap, imap = np.arange(st.NSC), np.arange(st.NIC)
        nss, nis = st.NSC, st.NIC

    def sc(c: int) -> int:            # a scalar column of the kernel's table
        return int(smap[c]) if c >= 0 else c

    def ic(c: int) -> int:            # an int column
        return int(imap[c]) if c >= 0 else c

    def fl(a) -> int:
        a = np.asarray(a.cpu() if hasattr(a, "cpu") else a,
                       np.float32).reshape(-1)
        floats.append(a)
        nfl[0] += a.size
        return nfl[0] - a.size

    tasks: List[int] = []

    def rec(kind: int, fields) -> None:
        tasks.append((kind << 24) | len(ints))
        ints.extend(int(x) for x in fields)

    # hint records name their slot list by its place in the tail; the
    # offsets are filled in once the tail's start is known
    slot_lists: Dict[tuple, List[int]] = {}
    seg_first = np.cumsum([0] + [len(cv.variants) for cv in st.convs])
    seg_recs: List[List[int]] = []
    for cv in st.convs:
        hint = -1
        if cv.hint is not None:
            h = cv.hint
            hint = len(ints)
            ints.extend([h.ipo, int(h.aL), int(h.aR), h.exclass])
            ints.extend(getattr(h, k) for k in HINT_W)
            ints.extend(sc(getattr(h, k)) for k in HINT_X)
            # the slot lists' offset (filled in below), the record's own
            # offset and the conv's a_off
            ints.extend([len(h.cross_cols), len(h.ex_cols), 0, hint,
                         cv.a_off])
            key = tuple((ic(a), sc(b), ic(c)) for a, b, c in
                        tuple(h.cross_cols) + tuple(h.ex_cols))
            slot_lists.setdefault(key, []).append(hint + HR_SLOTS)
        var_off = len(ints)
        ei = st.convs.index(cv)
        rec_off = var_off + VR_SIZE * len(cv.variants)
        for vi, v in enumerate(cv.variants):
            if v.fsel is None:
                r0 = -1
            else:
                r0 = v.fsel[0]
            lv = fl(t[f"lenvec{ei}_{vi}"])
            ints.extend([v.g_id, sc(v.h_col), v.len_lo, v.len_hi, v.width,
                         r0, int(v.vb_lo is not None), v.vb_lo or 0,
                         int(v.vb_hi is not None), v.vb_hi or 0, lv])
            boff = cv.a_off - v.len_hi
            seg_recs.append([
                rec_off, vi, ic(cv.gate_col), ic(cv.smin_col),
                ic(cv.smax_col), boff,
                INT_MIN if v.vb_lo is None else v.vb_lo,
                INT_MAX if v.vb_hi is None else v.vb_hi, v.width, v.g_id, lv,
                r0, cv.frame_mode, cv.lane, boff - cv.bpl - 1 + st.PAD, hint,
                sc(v.h_col), v.len_hi - cv.a_off + cv.bpl + 1])
        rec(T_CONV, [cv.state, cv.bpl, cv.a_off, cv.lane, cv.frame_mode,
                     ic(cv.smin_col), ic(cv.smax_col), ic(cv.gate_col),
                     len(cv.variants), var_off, hint, seg_first[ei]])
    for li, d in enumerate(st.lessd):
        lv = fl(t[d.lenvec_key])
        seg_recs.append([len(ints), -1, -1, 0, 0, 0, 0, 0, d.window, 0, lv,
                         0, 0, d.lane, st.PAD - d.window, -1, 0, 0])
        rec(T_LESSD, [d.state, d.lane, d.window, d.cum_id, sc(d.cumj_col),
                      sc(d.psi_col), ic(d.jsel_col), ic(d.jgate_col), lv,
                      li, seg_first[-1] + li])
    for c in st.chain:
        rec(T_CHAIN, [c.state, sc(c.emi_col)])
    for f in st.fixed:
        rec(T_FIXED, [f.state, f.jump, f.kind, f.lane, sc(f.emi_col),
                      sc(f.extra_col)])
    for p in st.pinned:
        rec(T_PINNED, [p.state, p.lane, sc(p.score_col), ic(p.eop_col),
                       ic(p.x_col), fl(t[p.x_key]) if p.x_key else -1])
    off_task = len(ints)
    ints.extend(tasks)
    off_seg = len(ints)
    for sg in seg_recs:
        ints.extend(sg)
    share = len(ints)
    for key, users in slot_lists.items():
        for u in users:                 # from the record's start
            ints[u] = len(ints) - (u - HR_SLOTS)
        for tr in key:
            ints.extend(tr)
    if not deep:
        share = len(ints)
    head = [n, st.S, st.NL, st.C, st.PAD, st.GPAD, st.NSC, st.NIC,
            ic(st.cls_col), len(tasks), off_task, n + st.PAD + END_PAD,
            st.GPAD + n + END_PAD, st.GPAD + n + 1 + END_PAD,
            st.PAD + n + END_PAD, st.GPAD + n + END_PAD, int(st.NHW > 0),
            len(st.convs), len(st.lessd), len(st.chain), len(st.fixed),
            len(st.pinned), len(segments(st)), off_seg]
    lay = smem_layout(st, share, nss + nis)
    head += [lay[k] for k in SMEM_REGIONS[:3]] + [lay["rw"]] + \
        [lay[k] for k in SMEM_REGIONS[3:]] + [lay["words"]]
    head += [share, nss, nis, int(deep), lay["bytes"]]
    ints[: len(head)] = head
    return np.asarray(ints, dtype=np.int64).astype(np.int32), \
        np.concatenate(floats)


def _check(st: ScanStatic, t: Dict[str, "torch.Tensor"], v0):
    """The device of a piece's tables after checking their types and shapes,
    and the kernel's descriptor."""
    import torch
    check_limits(st)
    dev = t["scalar_table"].device
    n, C = st.n, st.C
    ext = st.GPAD + n + END_PAD
    want = {"scalar_table": (torch.float32, (n, st.NSC)),
            "int_table": (torch.int32, (n, st.NIC)),
            "log_trans": (torch.float32, (C, st.S, st.S)),
            "lane_trans": (torch.float32, (st.NL, st.S)),
            "hw_all": (torch.float32, (st.NHW, ext))}
    G, cu = t["G_all"], t["cum_all"]
    want["G_all"] = (torch.float32, (G.shape[0], C, 3, ext))
    want["cum_all"] = (torch.float32, (cu.shape[0], C, ext + 1))
    if st.lessd:
        for k in ("lessd_bvalid_all", "lessd_bstop_all"):
            want[k] = (torch.int8, (len(st.lessd), st.PAD + n + END_PAD))
    for k, (dt, shape) in want.items():
        a = t[k]
        if a.device != dev:
            raise ValueError(f"{k} on {a.device}, expected {dev}")
        if a.dtype != dt:
            raise ValueError(f"{k} has dtype {a.dtype}, expected {dt}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{k} has shape {tuple(a.shape)}, expected "
                             f"{shape}")
        if not a.is_contiguous():
            raise ValueError(f"{k} is not contiguous")
    if tuple(v0.shape) != (st.S,) or v0.device != dev:
        raise ValueError("v0 must be the (S,) start column on the tables' "
                         "device")
    # what the kernel holds, on every device, so that the CPU refuses what
    # the card would
    return dev, _descriptor(st, {k: v for k, v in t.items()
                                 if "lenvec" in k or "pin_x" in k})


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 16 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def needs_ext(st: ScanStatic, desc_h) -> int:
    """1 when a piece needs csrc/scan.cu's EXT instantiation: the deep
    layout, or pinned states with further candidates at some position."""
    return int(bool(desc_h[D_DEEP_AT]) or any(p.x_col >= 0
                                              for p in st.pinned))


def _launch_fields(st: ScanStatic, t: Dict[str, "torch.Tensor"], v0,
                   debug_vals: bool, descs, dev):
    """What one piece's launch of csrc/scan.cu takes: (the arguments of
    scan_forward_launch from desc to v_final, as ints (pointers and sizes;
    0 for a null pointer), its dynamic shared memory in bytes, the outputs
    (bp, v_final, vals), the tensors that must outlive the launch)."""
    import torch
    desc_h, fdesc_h = descs
    n, S, NL = st.n, st.S, st.NL
    desc = torch.from_numpy(desc_h).to(dev)
    fdesc = torch.from_numpy(fdesc_h).to(dev)
    LW = n + st.PAD + END_PAD
    lanes = torch.full((NL, LW), float(NEG), dtype=torch.float32,
                       device=dev)
    largs = torch.zeros((NL, LW), dtype=torch.int8, device=dev)
    bp = torch.zeros((n, S), dtype=torch.int32, device=dev)
    vals = None
    if debug_vals:
        vals = torch.full((n, S), float(NEG), dtype=torch.float32,
                          device=dev)
        vals[0] = v0
    v_final = torch.empty(S, dtype=torch.float32, device=dev)
    empty8 = torch.zeros(1, dtype=torch.int8, device=dev)
    bv = t.get("lessd_bvalid_all", empty8)
    bs = t.get("lessd_bstop_all", empty8)
    v0 = v0.to(torch.float32).contiguous()

    stab, itab = kernel_tables(st, t, desc_h)

    def ptr(x):
        return x.data_ptr() if x is not None and x.numel() else 0
    fields = [ptr(desc), int(desc.shape[0]), ptr(fdesc), ptr(t["G_all"]),
              ptr(t["cum_all"]), ptr(t["log_trans"]), ptr(t["lane_trans"]),
              ptr(stab), ptr(itab), ptr(bv), ptr(bs),
              ptr(t["hw_all"]), ptr(v0), ptr(lanes), ptr(largs), ptr(bp),
              ptr(vals), ptr(v_final)]
    smem = int(desc_h[D_BYTES_AT])
    return fields, smem, (bp, v_final, vals), (desc, fdesc, lanes, largs,
                                               empty8, v0, stab, itab)


def kernel_tables(st: ScanStatic, t: Dict[str, "torch.Tensor"], desc_h):
    """The scalar and int tables as the kernel reads them: split_tracks'
    own, or for a deep piece (descriptor header D_DEEP) their copies with
    the columns in deep_perms' order."""
    import torch
    if not desc_h[D_DEEP_AT]:
        return t["scalar_table"], t["int_table"]
    ps, pi = deep_perms(st)
    dev = t["scalar_table"].device
    return (t["scalar_table"].index_select(
                1, torch.tensor(ps, device=dev)).contiguous(),
            t["int_table"].index_select(
                1, torch.tensor(pi, device=dev)).contiguous())


def scan_forward(st: ScanStatic, t: Dict[str, "torch.Tensor"], v0,
                 debug_vals: bool = False, defines=()):
    """(bp (n, S) int32, v_final (S,) float32, vals (n, S) float32 | None)
    of one piece (row j at base j; row 0 of bp 0, of vals v0).

    CPU tensors run the plain version; CUDA tensors launch csrc/scan.cu
    (and raise if it does not build or launch), built with the preprocessor
    `defines` of a measurement variant when they are given (K2_SIMPLE: the
    earlier design, a warp per state; K2_SPLIT: the clock64 split).
    `scan_forward.launches` counts kernel launches (scan_forward_batch's
    included)."""
    import torch
    dev, descs = _check(st, t, v0)
    if dev.type == "cpu":
        return scan_forward_reference(st, t, v0, debug_vals)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import load
    fn = load("scan", defines).scan_forward_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    fields, smem, out, keep = _launch_fields(st, t, v0, debug_vals, descs,
                                             dev)
    err = fn(*fields, smem, needs_ext(st, descs[0]),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_forward kernel launch failed: CUDA error "
                           f"{err}")
    del keep                  # freed in stream order after the launch
    scan_forward.launches += 1
    return out


scan_forward.launches = 0
scan_forward.batched_launches = 0
scan_forward.largest_grid = 0

# the static shared memory of a batched launch's block (its copy of the
# piece's arguments, csrc/scan.cu BatchRec, 144 bytes), beside the dynamic
BATCH_RECORD_BYTES = 256


def scan_forward_batch(pieces, debug_vals: bool = False) -> list:
    """scan_forward of every (st, t, v0) of `pieces`, all on one device:
    [(bp, v_final, vals)] in their order, each piece's bit-equal to its own
    launch.

    CPU tensors run the plain version piece after piece.  On the card one
    launch of csrc/scan.cu runs every piece, one block each, with the
    largest dynamic shared memory of the batch; each block copies its
    piece's record from a device array and runs the single launch's body.
    `scan_forward.batched_launches` counts these launches and
    `scan_forward.largest_grid` records the most pieces one took."""
    import torch
    if not pieces:
        return []
    checked = [_check(st, t, v0) for st, t, v0 in pieces]
    devs = {dev for dev, _ in checked}
    if len(devs) != 1:
        raise ValueError(f"pieces on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return [scan_forward_reference(st, t, v0, debug_vals)
                for st, t, v0 in pieces]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import load
    fn = load("scan").scan_forward_batch_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launches = [_launch_fields(st, t, v0, debug_vals, descs, dev)
                for (st, t, v0), (_, descs) in zip(pieces, checked)]
    ext = max(needs_ext(st, descs[0])
              for (st, _, _), (_, descs) in zip(pieces, checked))
    smem = max(x[1] for x in launches)
    if smem + BATCH_RECORD_BYTES > SMEM_BYTES:
        raise NotImplementedError(
            f"{smem} bytes of shared memory and a batch record (the "
            f"kernel's block may take {SMEM_BYTES})")
    recs = torch.tensor([x[0] for x in launches], dtype=torch.int64).to(dev)
    err = fn(recs.data_ptr(), len(pieces), smem, ext,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_forward batch launch failed: CUDA error "
                           f"{err}")
    del recs                  # freed in stream order after the launch
    scan_forward.launches += 1
    scan_forward.batched_launches += 1
    scan_forward.largest_grid = max(scan_forward.largest_grid, len(pieces))
    return [x[2] for x in launches]


_LSE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13 + \
    [ctypes.c_int, ctypes.c_void_p]


def scan_table(st: ScanStatic, t: Dict[str, "torch.Tensor"], v0,
               defines=()):
    """The forward rows (n, S) float32 of one piece (row j at base j, row 0
    v0), on the tables' device.

    CPU tensors run the plain version `scan_table_reference`; CUDA tensors
    launch csrc/scan_lse.cu (and raise if it does not build or launch),
    built with the preprocessor `defines` of a measurement variant when they
    are given (K5_SIMPLE: the earlier design, serial merges; K5_SPLIT: the
    clock64 split).  It takes what K2 takes (`_check`: the same limits and
    descriptor).  `scan_table.launches` counts kernel launches."""
    import torch
    dev, (desc_h, fdesc_h) = _check(st, t, v0)
    if dev.type == "cpu":
        return scan_table_reference(st, t, v0)[0]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import load
    fn = load("scan_lse", defines).scan_table_launch
    fn.argtypes = _LSE_ARGTYPES
    fn.restype = ctypes.c_int
    n, S, NL = st.n, st.S, st.NL
    desc = torch.from_numpy(desc_h).to(dev)
    fdesc = torch.from_numpy(fdesc_h).to(dev)
    lanes = torch.full((NL, n + st.PAD + END_PAD), float(NEG),
                       dtype=torch.float32, device=dev)
    rows = torch.full((n, S), float(NEG), dtype=torch.float32, device=dev)
    v0 = v0.to(torch.float32).contiguous()
    rows[0] = v0
    empty8 = torch.zeros(1, dtype=torch.int8, device=dev)
    stab, itab = kernel_tables(st, t, desc_h)

    def ptr(x):
        return x.data_ptr() if x.numel() else None

    err = fn(desc.data_ptr(), int(desc.shape[0]), fdesc.data_ptr(),
             ptr(t["G_all"]), ptr(t["cum_all"]), t["log_trans"].data_ptr(),
             t["lane_trans"].data_ptr(), stab.data_ptr(), itab.data_ptr(),
             ptr(t.get("lessd_bvalid_all", empty8)),
             ptr(t.get("lessd_bstop_all", empty8)), ptr(t["hw_all"]),
             v0.data_ptr(), lanes.data_ptr(), rows.data_ptr(),
             int(desc_h[D_BYTES_AT]),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_table kernel launch failed: CUDA error "
                           f"{err}")
    scan_table.launches += 1
    return rows


scan_table.launches = 0


def scan_table_work(st: ScanStatic, arrays: Dict[str, object]):
    """What one launch of K5 must move and compute, for the roofline bound:
    scan_work's reads and operations (the same entries, each a logsumexp
    term where K2 takes a maximum), with K5's own outputs: the rows (n, S)
    float32 and the lane values (no args) written once.  The exp and log
    evaluations are counted by the plain version (scan_table_reference)."""
    parts, ops = scan_work(st, arrays)
    parts["outputs"] = st.n * st.S * 4
    parts["scratch"] = (st.n - 1) * st.NL * 4
    return parts, ops


def heated(st: ScanStatic, arrays: Dict[str, object], heat: float):
    """split_tracks' arrays for a forward pass at heat (8 - t) / 8 of
    --temperature=t: every float32 array but log_init and log_term scaled
    by it, as augustus_tpu's ForwardEngine scales them (scan.py:954-970).
    A piece with sparse exon hints mixes count columns into its scalar
    table, so heat there raises NotImplementedError, as augustus_tpu refuses
    it (UnsupportedByDevice, scan.py:961-963)."""
    if heat == 1.0:
        return arrays
    if st.NHW:
        raise NotImplementedError(
            "temperature heating (--temperature) of a piece with sparse "
            "exon/CDS hints: refused, as augustus_tpu's ForwardEngine "
            "refuses it (UnsupportedByDevice, engine/scan.py:961-963)")
    if any(k.startswith("pin_x") for k in arrays):
        raise NotImplementedError(
            "temperature heating of a piece whose nc intron hints give "
            "several candidates at one position (sampling with --nc=on is "
            "refused)")
    h = np.float32(heat)
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        out[k] = (a * h).astype(np.float32) if a.dtype == np.float32 and \
            k not in ("log_init", "log_term") else v
    return out


class ScanForwardEngine:
    """The forward table of one piece over the split tables, in true log
    space, for the sampling walk (GoldEngine.sample_path): the counterpart
    of augustus_tpu's scan.ForwardEngine (scan.py:937-991) where K2 decodes
    the piece.  `split`: the (static, arrays) of the piece's ScanEngine, so
    that one split serves both passes; the heat of --temperature comes from
    the piece's constants."""

    def __init__(self, tracks: DPTracks, split, device):
        import torch
        self.tracks = tracks
        self.device = torch.device(device)
        self.static, arrays = split
        self.heat = (8.0 - tracks.gold.cn.temperature) / 8.0
        self.arrays = heated(self.static, arrays, self.heat)

    def rows(self) -> "torch.Tensor":
        """K5's rows (n, S) float32, rebased, on the device."""
        import torch
        from .. import stats
        with stats.stage("forward", self.device):
            t = scan_tensors(self.arrays, self.device)
            v0 = torch.from_numpy(np.asarray(
                self.tracks.log_init, np.float32)).to(self.device)
            return scan_table(self.static, t, v0)

    def run(self) -> np.ndarray:
        """The (n, S) float64 table: rows + tracks.base * heat, -inf where
        a row is at or below F32_NEG / 2 (augustus_tpu scan.py:977-988)."""
        n = self.static.n
        f = self.rows().cpu().numpy().astype(np.float64)
        base = np.asarray(self.tracks.base) * self.heat
        return np.where(f > float(F32_NEG) / 2, f + base[:n, None], -np.inf)


def scan_work(st: ScanStatic, arrays: Dict[str, object]):
    """What one launch must move and compute on this piece's data, for the
    roofline bound: ({part: bytes}, {part: float ops}), counted like
    engine/viterbi.py:kernel_work.

    Bytes count each input element that the function reads for these
    inputs once: the scalar and int table columns that a record names, on
    rows 1..n-1 (a convolution's H, quotient and index columns only where
    its gate is on); the G columns that a convolution's bands cover inside
    [smin, smax] (and vb_lo / vb_hi) at its gated positions, per (pool row,
    class, phase); the cumulative and mask columns that lessD windows
    cover; the hint window columns of hinted bands; the transition tables
    and length vectors once.  Outputs: bp (n, S) and v_final; the lane
    history written once (`scratch`: NL values and args per position).
    Ops: per position each chain state's and lane's S adds and maxima, a
    fixed or pinned state's 3, per lessD window entry 4 adds and a max, per
    band entry inside its bounds 3 adds and a max (`dp`), and per hinted
    band entry the quotient's fixed terms as engine/viterbi.py counts them
    (`hint_quot`; its per-slot terms, a few per entry, are left out)."""
    from .viterbi import QUOT_OPS, QUOT_SIDE_OPS
    n, S, NL, PAD, GPAD, C = st.n, st.S, st.NL, st.PAD, st.GPAD, st.C
    itab = np.asarray(arrays["int_table"])
    J = np.arange(1, n)
    rows = itab[1:n]
    cls = rows[:, st.cls_col].astype(np.int64)
    scol = np.zeros((n - 1, st.NSC), dtype=bool)
    icol = np.zeros((n - 1, st.NIC), dtype=bool)
    icol[:, st.cls_col] = True
    ext = GPAD + n + END_PAD
    NG = np.asarray(arrays["G_all"]).shape[0]
    gdiff = np.zeros((NG, C, 3, ext + 1), dtype=np.int64)
    NCU = np.asarray(arrays["cum_all"]).shape[0]
    cdiff = np.zeros((max(NCU, 1), C, ext + 2), dtype=np.int64)
    mdiff = np.zeros((max(len(st.lessd), 1), PAD + n + END_PAD + 1),
                     dtype=np.int64)
    hdiff = np.zeros((max(st.NHW, 1), ext + 1), dtype=np.int64)
    dp = quot = 0
    for c in st.chain:
        scol[:, c.emi_col] = True
    dp += (n - 1) * (len(st.chain) + NL) * S * 2
    for f in st.fixed:
        scol[:, f.emi_col] = True
        if f.extra_col >= 0:
            scol[:, f.extra_col] = True
    dp += (n - 1) * 3 * (len(st.fixed) + len(st.pinned))
    for p in st.pinned:
        scol[:, p.score_col] = True
        icol[:, p.eop_col] = True
    for li, d in enumerate(st.lessd):
        scol[:, [d.cumj_col, d.psi_col]] = True
        icol[:, [d.jsel_col, d.jgate_col]] = True
        W = d.window
        np.add.at(cdiff, (d.cum_id, cls, J - W + GPAD + 1), 1)
        np.add.at(cdiff, (d.cum_id, cls, J + GPAD + 1), -1)
        mdiff[li, J - W + PAD] += 1
        mdiff[li, J + PAD] -= 1
        dp += (n - 1) * W * 5
    for cv in st.convs:
        icol[:, cv.gate_col] = True
        gp = rows[:, cv.gate_col]
        on = (gp & 1) != 0
        if not on.any():
            continue
        jj, cc, ph = J[on], cls[on], (gp[on] >> 1).astype(np.int64)
        icol[on, cv.smin_col] = True
        icol[on, cv.smax_col] = True
        smin = rows[on, cv.smin_col].astype(np.int64)
        smax = rows[on, cv.smax_col].astype(np.int64)
        h = cv.hint
        if h is not None:
            cols = [getattr(h, k) for k in HINT_X] + \
                [c_ for tr in h.cross_cols + h.ex_cols for c_ in tr[1:2]]
            scol[np.ix_(on, cols)] = True
            icol[np.ix_(on, [c_ for tr in h.cross_cols + h.ex_cols
                             for c_ in (tr[0], tr[2])])] = True
        for v in cv.variants:
            scol[on, v.h_col] = True
            b0 = jj + cv.a_off - v.len_hi
            lo, hi = smin, smax
            if v.vb_lo is not None:
                lo = np.maximum(lo, v.vb_lo)
            if v.vb_hi is not None:
                hi = np.minimum(hi, v.vb_hi)
            lo = np.maximum(lo, b0)
            hi = np.minimum(hi, b0 + v.width - 1)
            k = hi >= lo
            np.add.at(gdiff, (v.g_id, cc[k], ph[k], lo[k] + GPAD), 1)
            np.add.at(gdiff, (v.g_id, cc[k], ph[k], hi[k] + GPAD + 1), -1)
            cnt = int((hi - lo + 1)[k].sum())
            dp += cnt * 4
            if h is not None:
                quot += cnt * (QUOT_OPS + QUOT_SIDE_OPS * (int(h.aL)
                                                           + int(h.aR)))
                for row in (getattr(h, k_) for k_ in HINT_W):
                    np.add.at(hdiff, (row, lo[k] - h.ipo - 1 + GPAD), 1)
                    np.add.at(hdiff, (row, hi[k] - h.ipo + 1 + GPAD), -1)
    covered = lambda d: int((np.cumsum(d, axis=-1) > 0).sum())  # noqa: E731
    lv = sum(np.asarray(v).size * 4 for k, v in arrays.items()
             if "lenvec" in k)
    parts = {"scalar_table": int(scol.sum()) * 4,
             "int_table": int(icol.sum()) * 4,
             "G_all": covered(gdiff) * 4,
             "cum_all": covered(cdiff) * 4 if st.lessd else 0,
             "lessd_masks": covered(mdiff) * 2 if st.lessd else 0,
             "hw_all": covered(hdiff) * 4 if st.NHW else 0,
             "constants": (C * S * S + NL * S + S) * 4 + lv,
             "outputs": (n * S + S) * 4,
             "scratch": (n - 1) * NL * 5}
    return parts, {"dp": dp, "hint_quot": quot}


def needs_general_scan(tracks: DPTracks) -> bool:
    """True for a piece that the 64-state kernel (engine/viterbi.py) cannot
    take and K2 decodes: more than 64 states or lanes, or a convolution
    variant with absolute begin bounds (the UTR states).  The reference
    routes such pieces to its scan engine the same way
    (augustus_tpu/predict.py:168-175)."""
    return tracks.S > 64 or tracks.n_lanes > 64 or any(
        v.vb_lo is not None or v.vb_hi is not None
        for cv in tracks.exon_conv for v in cv.variants)


class ScanEngine:
    """Split one piece's tracks, run K2 on `device`, and walk the
    backpointers where they lie (the port's counterpart of
    augustus_tpu/engine/scan.py:ScanEngine, without the bucket padding: the
    reference freezes its carry past n_true, so padding changes nothing)."""

    def __init__(self, tracks: DPTracks, device):
        import torch
        self.tracks = tracks
        self.device = torch.device(device)
        self.static, self.arrays = split_tracks(tracks)
        check_limits(self.static)
        self.n, self.S = self.static.n, self.static.S

    def inputs(self):
        """K2's tables and start column v0 on the engine's device (stage
        `expand`)."""
        import torch
        from .. import stats
        with stats.stage("expand", self.device):
            t = scan_tensors(self.arrays, self.device)
            v0 = torch.from_numpy(np.asarray(
                self.tracks.log_init, np.float32)).to(self.device)
        return t, v0

    def run(self, debug_vals: bool = False) -> None:
        from .. import stats
        t, v0 = self.inputs()
        with stats.stage("kernel", self.device):
            self.bp, vfin, self.vals = scan_forward(self.static, t, v0,
                                                    debug_vals)
        self.v_final = vfin.cpu().numpy()

    def _walk_start(self) -> int:
        last = self.v_final + np.asarray(self.tracks.log_term)
        state = int(np.argmax(last))
        if last[state] <= float(NEG) / 2:
            raise RuntimeError("No feasible path found in HMM (scan)")
        return state

    def trace_packed(self) -> Tuple[np.ndarray, int]:
        from .traceback import trace_packed
        return trace_packed(self.bp.cpu().numpy(), self._walk_start(),
                            self.n)

    def traceback(self) -> List[Tuple[int, int, ST]]:
        from .traceback import raw_segments
        packed, fb = self.trace_packed()
        return raw_segments(packed, fb, self.tracks.gold.sg.state_types)

    def traceback_path(self, dnalen: int):
        """Condensed PathState list by the event walk K4 over the (n, S)
        plane where the kernel left it; equals og.condense_path(traceback())."""
        from .traceback import path_by_events
        return path_by_events(self.bp, self._walk_start(), self.n, dnalen,
                              self.tracks.gold.sg.state_types)
