"""Packing of the DP tracks into the Viterbi kernel's planes.

Port of `augustus_tpu/engine/pallas_pack.py`.  `pack_tracks` yields the
same static description (`PKStatic`) and the same compact arrays as the
reference, as numpy arrays on the host route or, inside xputil.use_torch,
with the per-position arrays as tensors already on the card (the model
constants stay numpy); `expand_arrays` materializes the dense j-indexed
planes and the front-padded b-indexed windows on the tensors' device with
torch gathers and pads.

Layout (S <= 64 states, NL <= 64 lanes):
  sp_state (n_pad,128) f32   per-state scalar: chain/fixed emissions, lessD
                             gated log-psi, pinned scores (class baked in)
  sp_geo   (n_pad,128) f32   equalD log(1-psi) / longass geometric-branch
                             transition
  sp_convH (n_pad,256) f32   conv-variant H factors (h_lane / hv_base lanes)
  ip_conv  (n_pad,128) i32   conv gate|phi<<1, startMin, startMax (3 lanes
                             per conv, from lane 18)
  ip_misc  (n_pad,128) i32   pinned eop (lanes 0..7), lessD stop selectors
                             (8..15), GC class (16), fixed-group gates (17)
  gcum     (C, NGR, W_PAD+n_pad+EP) f32  G pool rows (pool*3+phase) then
                             intron cum1 rows, front-padded by W_PAD
  msk      (NMS, W_PAD+n_pad+EP) i32     lessD b_valid / b_stopflag rows
  ltc_all  (C,64,64) f32     log transitions (rows p, cols s) per GC class
  lt_T     (64,64) f32       lane transitions (rows p, cols l)
  sel_pack (NSEL,64,64) f32  fixed-state lane->state one-hot (0 / NEG)
  lv_pack  (1,LVP) f32       reversed length vectors and frame masks
With sparse exon/CDS hints (NHW > 0) three more planes:
  xh_plane (n_pad,NXH) f32   per-position hint scalars of the hinted convs
                             (cumulative tracks at x = j + base_offset, the
                             crossing/exact-match weights), one lane per
                             scalar-table column in use
  xi_plane (n_pad,NXI) i32   per-position hint ints (crossing starts and
                             flags, exact-match positions and kinds)
  hw_rows  (NHW, W_PAD+n_pad+EP) f32  b-indexed cumulative hint window rows,
                             W_PAD zero columns in front, the last value
                             repeated over the tail
Lanes are permuted so that the pinned-state lanes come first.

The TPU kernel's XH/XI planes were 128 lanes wide and its pack refused a
chunk with more hint columns; the port sizes them to the columns in use.
The TPU kernel additionally took `cls_blk`, per-2048-block GC-class runs
with at most two switches per block; the port's kernel reads the class of
every position from ip_misc lane 16, so any class pattern decodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DPTracks, F32_NEG
from . import xputil as U
from ..constants import ASS_MIDDLE, DSS_MIDDLE

W_PAD = 3200          # back-window: >= CONV_CAP + margins
BLK = 2048            # plane row padding unit (n_pad = multiple of BLK)
EP = 640              # end padding of b-indexed arrays
NEG = np.float32(F32_NEG)
GATE = np.float32(-1.0e29)
GATE_LANE, CLS_LANE = 17, 16
INT_FILL = np.int32(-(1 << 30))   # empty crossing / exact-match slot


@dataclass(frozen=True)
class PKVariant:
    width: int
    len_lo: int
    len_hi: int
    lv_off: int                  # offset of reversed lenvec in lv_pack
    fm_off: int                  # offset of 3 fsel masks (framed) or -1
    g3row: int                   # first row of this variant's G pool in gcum
    h_lane: int                  # sp_convH lane (scalar-H variants)
    # merged short band: a run of narrow variants collapsed into one band
    # with a per-length H vector read from consecutive sp_convH lanes and
    # up to two G pools switching at a static band index
    hv_base: int = -1            # sp_convH base lane of the H band, or -1
    g2row: int = -1              # second G pool row (band idx >= g2_from)
    g2_from: int = 0


@dataclass(frozen=True)
class PKHint:
    """Sparse exon/CDS hint quotient data for one conv state (mirrors
    scan.HintConvStatic): rows of hw_rows, and lanes of the per-position
    planes xh_plane (f32) / xi_plane (i32)."""
    ipo: int
    aL: bool
    aR: bool
    exclass: int
    # hw_rows rows
    w_be_ep: int; w_be_cp: int; w_cntbe_ep: int; w_cntbe_cp: int
    w_cr_ep: int; w_cr_cp: int; w_cntcr_ep: int; w_cntcr_cp: int
    w_cnte_ep: int; w_cnte_cp: int; w_zc: int
    # xh_plane lanes
    x_be_ep: int; x_be_cp: int; x_cntbe_ep: int; x_cntbe_cp: int
    x_c2_ep: int; x_cntc2_ep: int
    x_cnte_ep: int; x_cnte_cp: int; x_zc: int
    x_tx_ep: int; x_tx_cp: int; x_txc_ep: int; x_txc_cp: int
    # K slots: (xi start lane, xh weight lane, xi flag lane) per slot
    cross: Tuple[Tuple[int, int, int], ...]
    # K2 slots: (xi position lane, xh weight lane, xi kind lane) per slot
    ex: Tuple[Tuple[int, int, int], ...]


@dataclass(frozen=True)
class PKConv:
    state: int
    bpl: int
    a_off: int
    lane: int                    # lane (3 consecutive if frame_mode)
    frame_mode: int
    ip_lane: int                 # ip_conv lane of gate|phi<<1 (then +1,+2)
    variants: Tuple[PKVariant, ...]
    hint: Optional[PKHint] = None


@dataclass(frozen=True)
class PKLessD:
    state: int
    lane: int
    window: int
    cum_row: int                 # gcum row of the intron cum1 track
    valid_row: int               # msk row of b_valid
    stop_row: int                # msk row of b_stopflag
    lv_off: int
    jsel_lane: int               # ip_misc lane


@dataclass(frozen=True)
class PKFixedGroup:
    jump: int
    kind: int                    # 0 plain, 1 equalD(+extra), 2 longass(A/B)
    sel_idx: int                 # index of A matrix in sel_pack
    selb_idx: int                # index of B matrix or -1
    gate_bit: int                # bit in ip_misc gate lane
    states: Tuple[int, ...]


@dataclass(frozen=True)
class PKPinned:
    state: int
    lane: int                    # post-permutation lane (< 8)
    eop_lane: int                # ip_misc lane


@dataclass(frozen=True)
class PKStatic:
    n: int
    n_pad: int
    n_blocks: int
    S: int
    NL: int
    C: int
    NGR: int                     # rows of gcum
    NMS: int                     # rows of msk
    NSEL: int
    LVP: int
    chain_states: Tuple[int, ...]
    fixed_groups: Tuple[PKFixedGroup, ...]
    lessd: Tuple[PKLessD, ...]
    pinned: Tuple[PKPinned, ...]
    convs: Tuple[PKConv, ...]
    gate_lane: int               # ip_misc lane of fixed group gate bits
    cls_lane: int                # ip_misc lane of the GC class
    NHW: int = 0                 # hint window rows (0 = no sparse hints)
    hint_lm: Optional[tuple] = None   # (lm_ep, lm_cp, lm_exon, lm_CDS,
    #                                   lm_local_cp) as Python floats
    PHW: int = 8192              # the TPU kernel's pinned-history ring size


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_tracks(tr: DPTracks):
    """(static, arrays): kernel inputs from DPTracks (see the module
    docstring for the backends)."""
    from .scan import split_tracks
    xp = U.A.xp
    st, arr = split_tracks(tr)       # the consolidated scalar tables
    n, S, C = st.n, tr.S, st.C
    NL = tr.n_lanes
    if S > 64 or NL > 64:
        raise NotImplementedError(
            f"S={S} states / NL={NL} lanes: the Viterbi kernel takes at most "
            "64 of each; such pieces take the general kernel K2 "
            "(engine/scan.py, chosen by predict._engine and viterbi.k1_fits)")
    n_blocks = -(-n // BLK)
    n_pad = n_blocks * BLK

    stab = arr["scalar_table"]       # (n, NSC) f32, class baked in
    itab = arr["int_table"]          # (n, NIC) int32

    # ---- lane permutation: pinned lanes first ---------------------------
    pin_lanes = [p.lane for p in st.pinned]
    rest = [l for l in range(NL) if l not in pin_lanes]
    order = pin_lanes + rest                     # old lane at position new
    lane_of = {old: new for new, old in enumerate(order)}
    for c in st.convs:
        if c.frame_mode:
            assert lane_of[c.lane + 1] == lane_of[c.lane] + 1
            assert lane_of[c.lane + 2] == lane_of[c.lane] + 2

    # ---- plane maps: plane lane -> table column ------------------------
    m_sp_state = np.full(128, -1, dtype=np.int32)
    m_sp_geo = np.full(128, -1, dtype=np.int32)
    m_sp_convH = np.full(256, -1, dtype=np.int32)
    m_ip_conv = np.full(128, -1, dtype=np.int32)
    m_ip_misc = np.full(128, -1, dtype=np.int32)
    xtra_s: List[np.ndarray] = []     # host-derived extra scalar columns
    xtra_i: List[np.ndarray] = []

    def xscol(vals) -> int:
        xtra_s.append(U.astype(xp.asarray(vals), np.float32))
        return stab.shape[1] + len(xtra_s) - 1

    def xicol(vals) -> int:
        xtra_i.append(U.astype(xp.asarray(vals), np.int32))
        return itab.shape[1] + len(xtra_i) - 1

    pos = U.arange(n)
    m_ip_misc[CLS_LANE] = st.cls_col

    # ---- chain ----------------------------------------------------------
    chain_states = []
    for cs in st.chain:
        m_sp_state[cs.state] = cs.emi_col
        chain_states.append(cs.state)

    # ---- fixed groups by (jump, kind) -----------------------------------
    by_key: Dict[Tuple[int, int], List] = {}
    for fs in st.fixed:
        by_key.setdefault((fs.jump, fs.kind), []).append(fs)
    sel_list: List[np.ndarray] = []
    groups: List[PKFixedGroup] = []
    # splice-signal emissions feed the bare lanes consumed by equalD: a
    # finite lane value at j-D requires a finite fixed-state emission there
    dss_any = xp.zeros(n, dtype=bool)
    for fs in st.fixed:
        dss_any = dss_any | (stab[:, fs.emi_col] > float(NEG) / 2)
    gb = xp.zeros(n, dtype=np.int32)
    for gi, (key, fss) in enumerate(sorted(by_key.items())):
        jump, kind = key
        selA = np.full((64, 64), NEG, dtype=np.float32)
        selB = np.full((64, 64), NEG, dtype=np.float32)
        any_emi = xp.zeros(n, dtype=bool)
        for fs in fss:
            s = fs.state
            m_sp_state[s] = fs.emi_col
            any_emi = any_emi | (stab[:, fs.emi_col] > float(NEG) / 2)
            selA[lane_of[fs.lane], s] = 0.0
            if fs.kind in (1, 2):
                m_sp_geo[s] = fs.extra_col
            if fs.kind == 2:
                selB[lane_of[fs.lane + 1], s] = 0.0
        sel_idx = len(sel_list)
        sel_list.append(selA)
        selb_idx = -1
        if kind == 2:
            selb_idx = len(sel_list)
            sel_list.append(selB)
        if kind == 1:
            # lane source is a bare dss value at j - jump; at j == jump the
            # lane holds the initial value l0 instead
            if jump < n:
                src = xp.concatenate([xp.zeros(jump, dtype=bool),
                                      dss_any[: n - jump]])
            else:
                src = xp.zeros(n, dtype=bool)
            src = src | (pos == min(jump, n - 1))
            gate = any_emi & src & (pos >= jump)
        else:
            gate = any_emi & (pos >= jump)
        gb = gb | (U.astype(gate, np.int32) << gi)
        groups.append(PKFixedGroup(jump=jump, kind=kind, sel_idx=sel_idx,
                                   selb_idx=selb_idx, gate_bit=gi,
                                   states=tuple(fs.state for fs in fss)))
    m_ip_misc[GATE_LANE] = xicol(gb)

    # ---- lenvec / fsel-mask pack ----------------------------------------
    lv_parts: List[np.ndarray] = []
    lv_cursor = [0]

    def lv_add(vec: np.ndarray) -> int:
        off = lv_cursor[0]
        v = np.asarray(vec, dtype=np.float32).ravel()
        lv_parts.append(v)
        lv_cursor[0] += v.shape[0]
        return off

    # ---- G/cum sources (gcum assembled by expand_arrays) ----------------
    G_all = arr["G_all"]             # (NG, C, 3, GPAD + n + END_PAD)
    cum_all = arr["cum_all"]         # (NCU, C, GPAD + n + 1 + END_PAD)
    NG = G_all.shape[0]
    NCU = cum_all.shape[0]
    from .device import END_PAD
    GPAD = G_all.shape[-1] - n - END_PAD
    NGR = _round_up(NG * 3 + NCU, 8)
    G_src = G_all[:, :, :, GPAD: GPAD + n]
    cum_src = cum_all[:, :, GPAD + 1: GPAD + 1 + n]     # cum1[p]

    # ---- lessD ----------------------------------------------------------
    lessd_list: List[PKLessD] = []
    NMS = _round_up(max(2 * len(st.lessd), 1), 8)
    bv_all = arr.get("lessd_bvalid_all")
    bs_all = arr.get("lessd_bstop_all")
    bv_rows: List = []
    bs_rows: List = []
    for li, lsd in enumerate(st.lessd):
        pad_scan = bv_all.shape[1] - n - END_PAD
        bv_rows.append(bv_all[li, pad_scan: pad_scan + n])
        bs_rows.append(bs_all[li, pad_scan: pad_scan + n])
        off = lv_add(np.asarray(arr[lsd.lenvec_key]))  # already reversed
        # fold j_gate into psi: all scores NEG when the end is gated off
        psi = stab[:, lsd.psi_col]
        jgate = itab[:, lsd.jgate_col] != 0
        m_sp_state[lsd.state] = xscol(xp.where(jgate, psi, NEG))
        lessd_list.append(PKLessD(
            state=lsd.state, lane=lane_of[lsd.lane], window=lsd.window,
            cum_row=NG * 3 + lsd.cum_id, valid_row=2 * li,
            stop_row=2 * li + 1, lv_off=off, jsel_lane=8 + li))
        m_ip_misc[8 + li] = lsd.jsel_col
    bv_src = xp.stack(bv_rows) if bv_rows else xp.zeros((0, n), np.int8)
    bs_src = xp.stack(bs_rows) if bs_rows else xp.zeros((0, n), np.int8)

    # ---- pinned ------------------------------------------------------------
    # PHW: the reference kernel's pinned-history ring, sized to the furthest
    # back-reference j - eop (kept in the static for parity; the port keeps
    # the full history instead of a ring)
    pinned_list: List[PKPinned] = []
    cn_ = tr.gold.cn
    max_allowed = (cn_.max_exon_len - cn_.ass_upwindow_size - cn_.ass_start
                   - ASS_MIDDLE - DSS_MIDDLE - cn_.dss_start)
    reach = W_PAD
    for pi, psd in enumerate(st.pinned):
        m_sp_state[psd.state] = psd.score_col
        m_ip_misc[pi] = psd.eop_col
        g_ = tr.gold.geom[tr.gold.sg.state_types[psd.state]]
        reach = max(reach, max_allowed + g_.begin_part_len + 64)
        new_lane = lane_of[psd.lane]
        assert new_lane < 8
        pinned_list.append(PKPinned(state=psd.state, lane=new_lane,
                                    eop_lane=pi))
    PHW = 8192
    while PHW < reach + W_PAD + BLK + 256:
        PHW *= 2

    # ---- convs ---------------------------------------------------------------
    # ---- sparse exon/CDS hint planes ------------------------------------
    # x-side per-position scalars (stab/itab columns) are packed into two
    # j-planes XH (f32) / XI (i32), one lane per column in use (first use
    # first, as the reference assigns its 128 lanes); window rows (hw_all)
    # into a b-indexed array like gcum.
    _xh_lanes: Dict[int, int] = {}
    _xi_lanes: Dict[int, int] = {}

    def xh_lane(col: int) -> int:
        return _xh_lanes.setdefault(col, len(_xh_lanes))

    def xi_lane(col: int) -> int:
        return _xi_lanes.setdefault(col, len(_xi_lanes))

    def pk_hint(hs) -> PKHint:
        return PKHint(
            ipo=hs.ipo, aL=hs.aL, aR=hs.aR, exclass=hs.exclass,
            w_be_ep=hs.w_be_ep, w_be_cp=hs.w_be_cp,
            w_cntbe_ep=hs.w_cntbe_ep, w_cntbe_cp=hs.w_cntbe_cp,
            w_cr_ep=hs.w_cr_ep, w_cr_cp=hs.w_cr_cp,
            w_cntcr_ep=hs.w_cntcr_ep, w_cntcr_cp=hs.w_cntcr_cp,
            w_cnte_ep=hs.w_cnte_ep, w_cnte_cp=hs.w_cnte_cp, w_zc=hs.w_zc,
            x_be_ep=xh_lane(hs.x_be_ep), x_be_cp=xh_lane(hs.x_be_cp),
            x_cntbe_ep=xh_lane(hs.x_cntbe_ep),
            x_cntbe_cp=xh_lane(hs.x_cntbe_cp),
            x_c2_ep=xh_lane(hs.x_c2_ep), x_cntc2_ep=xh_lane(hs.x_cntc2_ep),
            x_cnte_ep=xh_lane(hs.x_cnte_ep), x_cnte_cp=xh_lane(hs.x_cnte_cp),
            x_zc=xh_lane(hs.x_zc),
            x_tx_ep=xh_lane(hs.x_tx_ep), x_tx_cp=xh_lane(hs.x_tx_cp),
            x_txc_ep=xh_lane(hs.x_txc_ep), x_txc_cp=xh_lane(hs.x_txc_cp),
            cross=tuple((xi_lane(sc), xh_lane(wc), xi_lane(fc))
                        for (sc, wc, fc) in hs.cross_cols),
            ex=tuple((xi_lane(pc), xh_lane(wc), xi_lane(kc))
                     for (pc, wc, kc) in hs.ex_cols))

    hw_all = arr["hw_all"]                       # (NHW, GPAD + n + END_PAD)
    NHW = hw_all.shape[0]
    NHWp = _round_up(max(NHW, 1), 8)
    gp_scan = hw_all.shape[1] - n - END_PAD
    hw_src = hw_all[:, gp_scan: gp_scan + n]

    conv_list: List[PKConv] = []
    _next_h = [0]

    def h_alloc(w: int) -> int:
        base = _next_h[0]
        assert base + w <= 256, "sp_convH lane budget exceeded"
        _next_h[0] = base + w
        return base

    for ci, ecs in enumerate(st.convs):
        if any(v.vb_lo is not None or v.vb_hi is not None
               for v in ecs.variants):
            raise NotImplementedError("begin-bounded (UTR) conv variants")
        vs: List[PKVariant] = []
        raw = list(ecs.variants)
        _vi_of = {id(v): i for i, v in enumerate(raw)}
        # ---- merge the leading run of narrow variants -------------------
        t_ = 0
        while (t_ < len(raw) and raw[t_].width <= 24
               and (t_ == 0 or raw[t_].len_lo == raw[t_ - 1].len_hi + 1)):
            t_ += 1
        group = raw[:t_]
        span = (group[-1].len_hi - group[0].len_lo + 1) if t_ >= 2 else 0
        merged_ok = t_ >= 2 and span <= 64
        if merged_ok:
            # band coords: widx 0 <-> len_hi (descending length)
            owners = []
            for v in reversed(group):
                owners.extend([v] * v.width)
            gseq = [v.g_id for v in owners]
            switches = [w for w in range(1, span)
                        if gseq[w] != gseq[w - 1]]
            merged_ok = len(switches) <= 1
        if merged_ok:
            len_hi_m = group[-1].len_hi
            rv = np.concatenate(
                [np.asarray(arr[f"lenvec{ci}_{_vi_of[id(v)]}"])
                 for v in reversed(group)])
            lvoff = lv_add(rv)
            fmoff = -1
            if group[0].fsel is not None:
                fs = []
                for v in reversed(group):
                    fs.extend(v.fsel)
                m = np.zeros((3, span), dtype=np.float32)
                for w, f in enumerate(fs):
                    m[f, w] = 1.0
                fmoff = lv_add(m[0])
                lv_add(m[1])
                lv_add(m[2])
            base_lane = h_alloc(span)
            for w, v in enumerate(owners):
                m_sp_convH[base_lane + w] = v.h_col
            g2row, g2from = -1, 0
            if switches:
                g2row = gseq[switches[0]] * 3
                g2from = switches[0]
            vs.append(PKVariant(
                width=span, len_lo=group[0].len_lo, len_hi=len_hi_m,
                lv_off=lvoff, fm_off=fmoff, g3row=gseq[0] * 3,
                h_lane=-1, hv_base=base_lane, g2row=g2row,
                g2_from=g2from))
            rest = raw[t_:]
        else:
            rest = raw
        for var in rest:
            vi = _vi_of[id(var)]
            lvoff = lv_add(np.asarray(arr[f"lenvec{ci}_{vi}"]))
            fmoff = -1
            if var.fsel is not None:
                m = np.zeros((3, var.width), dtype=np.float32)
                for w, f in enumerate(var.fsel):
                    m[f, w] = 1.0
                fmoff = lv_add(m[0])
                lv_add(m[1])
                lv_add(m[2])
            h_lane = h_alloc(1)
            m_sp_convH[h_lane] = var.h_col
            vs.append(PKVariant(width=var.width, len_lo=var.len_lo,
                                len_hi=var.len_hi, lv_off=lvoff,
                                fm_off=fmoff, g3row=var.g_id * 3,
                                h_lane=h_lane))
        ip_lane = 18 + ci * 3
        assert ip_lane + 2 < 64
        m_ip_conv[ip_lane] = ecs.gate_col
        m_ip_conv[ip_lane + 1] = ecs.smin_col
        m_ip_conv[ip_lane + 2] = ecs.smax_col
        conv_list.append(PKConv(
            state=ecs.state, bpl=ecs.bpl, a_off=ecs.a_off,
            lane=lane_of[ecs.lane], frame_mode=ecs.frame_mode,
            ip_lane=ip_lane, variants=tuple(vs),
            hint=pk_hint(ecs.hint) if ecs.hint is not None else None))

    LVP = _round_up(max(lv_cursor[0], 128), 128)
    lv_pack = np.full((1, LVP), NEG, dtype=np.float32)
    o = 0
    for part in lv_parts:
        lv_pack[0, o: o + part.shape[0]] = part
        o += part.shape[0]

    # ---- transitions / lanes / init -----------------------------------------
    ltc_all = np.full((C, 64, 64), NEG, dtype=np.float32)
    ltc_all[:, :S, :S] = arr["log_trans"]
    lane_trans = arr["lane_trans"][order]          # permuted lanes
    lt_T = np.full((64, 64), NEG, dtype=np.float32)
    lt_T[:S, :NL] = lane_trans.T
    sel_pack = (np.stack(sel_list) if sel_list
                else np.zeros((1, 64, 64), np.float32))

    v0 = np.full((1, 64), NEG, dtype=np.float32)
    v0[0, :S] = arr["log_init"]
    lane_cand = arr["log_init"][None, :] + lane_trans
    l0 = np.full((1, 64), NEG, dtype=np.float32)
    l0[0, :NL] = lane_cand.max(axis=1)
    a0 = np.zeros((1, 64), dtype=np.int32)
    a0[0, :NL] = lane_cand.argmax(axis=1)

    static = PKStatic(
        n=n, n_pad=n_pad, n_blocks=n_blocks, S=S, NL=NL, C=C, NGR=NGR,
        NMS=NMS, NSEL=len(sel_pack), LVP=LVP,
        chain_states=tuple(chain_states),
        fixed_groups=tuple(groups), lessd=tuple(lessd_list),
        pinned=tuple(pinned_list), convs=tuple(conv_list),
        gate_lane=GATE_LANE, cls_lane=CLS_LANE,
        NHW=NHWp if any(c.hint is not None for c in conv_list) else 0,
        hint_lm=st.hint_lm, PHW=PHW)

    arrays = {
        "stab": stab, "itab": itab,
        "xstab": (xp.stack(xtra_s, axis=1) if xtra_s
                  else xp.zeros((n, 0), np.float32)),
        "xitab": (xp.stack(xtra_i, axis=1) if xtra_i
                  else xp.zeros((n, 0), np.int32)),
        "m_sp_state": m_sp_state, "m_sp_geo": m_sp_geo,
        "m_sp_convH": m_sp_convH, "m_ip_conv": m_ip_conv,
        "m_ip_misc": m_ip_misc,
        "G_src": G_src, "cum_src": cum_src,
        "bv_src": bv_src, "bs_src": bs_src,
        "ltc_all": ltc_all, "lt_T": lt_T, "sel_pack": sel_pack,
        "lv_pack": lv_pack, "v0": v0, "l0": l0, "a0": a0,
        "log_term": np.asarray(arr["log_term"]),
    }
    if static.NHW:
        arrays["m_xh"] = np.array(list(_xh_lanes), dtype=np.int32)
        arrays["m_xi"] = np.array(list(_xi_lanes), dtype=np.int32)
        arrays["hw_src"] = hw_src
    return static, arrays


# compact arrays that expand_arrays consumes, and the small per-chunk
# constants the kernel takes as they are
PLANE_INPUTS = ("stab", "itab", "xstab", "xitab", "m_sp_state", "m_sp_geo",
                "m_sp_convH", "m_ip_conv", "m_ip_misc", "G_src", "cum_src",
                "bv_src", "bs_src")
KERNEL_CONSTANTS = ("ltc_all", "lt_T", "sel_pack", "lv_pack", "v0", "l0",
                    "a0")
# compact inputs of the hint planes, present only when static.NHW > 0
HINT_INPUTS = ("m_xh", "m_xi", "hw_src")


def to_device(arrays: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    """The compact arrays the decode needs as contiguous tensors on
    `device`: one host->device copy of each numpy array; tensors already
    there (the device route's) stay."""
    out = {}
    for k in PLANE_INPUTS + KERNEL_CONSTANTS + HINT_INPUTS:
        if k in arrays:
            v = arrays[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(device).contiguous()
    return out


def expand_arrays(st: PKStatic, a: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Materialize the kernel's dense planes from the compact tensors, on
    their device.  Bit-identical to the reference's jnp expansion (gathers,
    selects and pads only: no arithmetic)."""
    n, n_pad, C = st.n, st.n_pad, st.C
    dev = a["stab"].device
    tabs = torch.cat([a["stab"], a["xstab"]], dim=1) \
        if a["xstab"].shape[1] else a["stab"]
    tabi = torch.cat([a["itab"], a["xitab"]], dim=1) \
        if a["xitab"].shape[1] else a["itab"]

    def plane(tab, m, default, dtype):
        m = m.long()
        g = tab.index_select(1, torch.clamp(m, min=0)).to(dtype)
        g = torch.where((m >= 0)[None, :], g,
                        torch.tensor(default, dtype=dtype, device=dev))
        out = torch.full((n_pad, m.shape[0]), default, dtype=dtype,
                         device=dev)
        out[:n] = g
        return out

    out = {
        "sp_state": plane(tabs, a["m_sp_state"], float(NEG), torch.float32),
        "sp_geo": plane(tabs, a["m_sp_geo"], 0.0, torch.float32),
        "sp_convH": plane(tabs, a["m_sp_convH"], float(NEG), torch.float32),
        "ip_conv": plane(tabi, a["m_ip_conv"], 0, torch.int32),
        "ip_misc": plane(tabi, a["m_ip_misc"], 0, torch.int32),
    }
    if st.NHW:
        out["xh_plane"] = plane(tabs, a["m_xh"], 0.0, torch.float32)
        out["xi_plane"] = plane(tabi, a["m_xi"], int(INT_FILL), torch.int32)
        hw = a["hw_src"]                  # (rows in use, n)
        hw_rows = torch.zeros((st.NHW, W_PAD + n_pad + EP),
                              dtype=torch.float32, device=dev)
        hw_rows[: hw.shape[0], W_PAD: W_PAD + n] = hw
        hw_rows[: hw.shape[0], W_PAD + n:] = hw[:, n - 1: n]
        out["hw_rows"] = hw_rows

    # gcum: rows [g*3+ph for g, ph] then [NG*3+u], padded to NGR, cols
    # front-padded by W_PAD and NEG beyond n
    G = a["G_src"]                        # (NG, C, 3, n)
    NG = G.shape[0]
    cum = a["cum_src"]                    # (NCU, C, n)
    NCU = cum.shape[0]
    gcum = torch.full((C, st.NGR, W_PAD + n_pad + EP), float(NEG),
                      dtype=torch.float32, device=dev)
    if NG:
        gcum[:, : NG * 3, W_PAD: W_PAD + n] = \
            G.permute(1, 0, 2, 3).reshape(C, NG * 3, n)
    if NCU:
        gcum[:, NG * 3: NG * 3 + NCU, W_PAD: W_PAD + n] = \
            cum.permute(1, 0, 2)
    out["gcum"] = gcum

    bv = a["bv_src"].to(torch.int32)      # (L, n)
    bs = a["bs_src"].to(torch.int32)
    L = bv.shape[0]
    msk = torch.zeros((st.NMS, W_PAD + n_pad + EP), dtype=torch.int32,
                      device=dev)
    if L:
        msk[: 2 * L, W_PAD: W_PAD + n] = \
            torch.stack([bv, bs], dim=1).reshape(2 * L, n)
    out["msk"] = msk
    return out


def _lenvec_mask(st: PKStatic, size: int) -> np.ndarray:
    """The entries of lv_pack that hold length vectors (log tables), not
    frame masks."""
    m = np.zeros(size, dtype=bool)
    for d in st.lessd:
        m[d.lv_off: d.lv_off + d.window] = True
    for cv in st.convs:
        for v in cv.variants:
            m[v.lv_off: v.lv_off + v.width] = True
    return m


def forward_arrays(st: PKStatic, arrays: Dict[str, object], heat: float
                   ) -> Dict[str, object]:
    """pack_tracks' host arrays for the forward table (engine/forward.py):
    a copy with

    * the float log tables heated: multiplied by `heat` = (8 - t) / 8 for
      --temperature=t, as augustus_tpu's ForwardEngine multiplies every
      float32 table of split_tracks but log_init/log_term
      (augustus_tpu/engine/scan.py:955-973).  Here that is stab, xstab
      (the lessD psi column), G_src, cum_src, ltc_all, lt_T and the length
      vectors of lv_pack; v0, log_term, sel_pack (a structural one-hot),
      the frame masks of lv_pack and the integer tables stay.  A chunk with
      sparse exon hints mixes count columns into its scalar table, so heat
      there raises NotImplementedError, as the reference refuses it;
    * `l0`, the initial lane values, as the logsumexp of v0 + lane
      transitions over the states, gated at GATE (scan.py:921-927), where
      pack_tracks gives the Viterbi kernel their maximum."""
    out = dict(arrays)
    if heat != 1.0:
        if st.NHW:
            raise NotImplementedError(
                "temperature heating (--temperature) of a piece with sparse "
                "exon/CDS hints: refused, as augustus_tpu's ForwardEngine "
                "refuses it (UnsupportedByDevice, engine/scan.py:961-963)")
        h = np.float32(heat)
        for k in ("stab", "xstab", "G_src", "cum_src", "ltc_all", "lt_T"):
            out[k] = (np.asarray(arrays[k]) * h).astype(np.float32)
        lv = np.asarray(arrays["lv_pack"])
        m = _lenvec_mask(st, lv.shape[1])[None, :]
        out["lv_pack"] = np.where(m, lv * h, lv).astype(np.float32)
    S, NL = st.S, st.NL
    v0 = np.asarray(out["v0"])[0, :S]
    cand = v0[None, :] + np.asarray(out["lt_T"])[:S, :NL].T   # (NL, S)
    mx = cand.max(axis=1)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        ssum = np.where(cand > GATE, np.exp(cand - mx[:, None]),
                        np.float32(0)).sum(axis=1, dtype=np.float32)
        lse = mx + np.log(ssum)
    l0 = np.full((1, 64), NEG, dtype=np.float32)
    l0[0, :NL] = np.where(mx > GATE, lse, NEG)
    out["l0"] = l0
    return out
