"""Semi-Markov Viterbi forward pass: the plain version and its engine.

`viterbi_forward_reference` is the plain PyTorch version (an eager loop
over positions) of the recursion that the program's K1 computes,
`augustus_tpu/engine/pallas_scan.py:make_kernel` and its sparse exon/CDS
hint quotient included; `viterbi_forward` runs it on CPU tensors.  The
descriptor and shared-memory arithmetic below decide, as in the program,
which pieces this recursion takes (`k1_fits`).

What bounds the kernel on the card: the recursion is sequential over the n
positions of a chunk (position j reads the values of j-1 and the lane
history of older positions), so one chunk runs in one thread block on one
SM, and the latency of each position's dependent chain sets the pace.  The
kernel walks only the unmasked begins of each exon convolution's band,
stages each position's plane rows in shared memory ahead of use, keeps the
transition tables on chip, and takes the lane and chain maxima over the
possible predecessors only
(csrc/viterbi.cu says why each is exact).  `smem_layout` sizes its shared
memory and refuses, with NotImplementedError, a chunk beyond it.

Outputs, for positions j = 0 .. n-1 and states s < 64:
  bp     (n, 64) int32   packed backpointer (pred << 20) | off; row j is the
                         reference scan's bps[j-1]; row 0 is 0
  v_final (64,) float32  Viterbi values at n-1
  vals   (n, 64) float32 per-step values (debug_vals=True); row 0 is v0
States gated off at j get value NEG and a backpointer that is never read
(off 0 for fixed-jump states, pred 0 / off 1 otherwise).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DPTracks, F32_NEG
from .pack import (GATE, KERNEL_CONSTANTS, W_PAD, PKStatic, expand_arrays,
                   pack_tracks, to_device)

NEG = np.float32(F32_NEG)
MAX_DESC = 4096       # descriptor ints the kernel holds in shared memory
MAX_SLOTS = 64        # crossing (K) / exact-match (K2) hint slots per conv

# the kernel's shape (csrc/k1_common.cuh): threads, the warps that take warp
# items and the plane rows staged ahead
NTHREADS = 768
ITEM_WARPS = NTHREADS // 32 - 2
STAGES = 8
MAX_VAR = 16          # variants of one conv
NX = 13               # hint scalars of a hinted conv at one position
IPM_W = 32            # ip_misc lanes staged per position
SMEM_LIMIT = 232_448  # shared memory one block may have on an H100

# the order of a hint record's window rows and x lanes in the descriptor
# (csrc/k1_common.cuh HR_W / HR_X)
HINT_W_ROWS = ("w_be_ep", "w_be_cp", "w_cntbe_ep", "w_cntbe_cp", "w_cr_ep",
               "w_cr_cp", "w_cntcr_ep", "w_cntcr_cp", "w_cnte_ep",
               "w_cnte_cp", "w_zc")
HINT_X_LANES = ("x_be_ep", "x_be_cp", "x_cntbe_ep", "x_cntbe_cp", "x_c2_ep",
                "x_cntc2_ep", "x_cnte_ep", "x_cnte_cp", "x_zc", "x_tx_ep",
                "x_tx_cp", "x_txc_ep", "x_txc_cp")
# window rows read at bob - 1 (the others at bob)
_W_AT_BOB_M1 = ("w_be_ep", "w_be_cp", "w_cntbe_ep", "w_cntbe_cp",
                "w_cnte_ep", "w_cnte_cp", "w_zc")


# --------------------------------------------------------------------------
# descriptor: the static chunk structure as one int32 array for the kernel
# --------------------------------------------------------------------------

def _fixed_lanes(st: PKStatic, sel_pack: np.ndarray):
    """(state, laneA, laneB, kind, jump, gate_bit) per fixed-jump state.
    The lane of a state is the row of its one-hot column in sel_pack."""
    out = []
    for g in st.fixed_groups:
        for s in g.states:
            la = int(np.flatnonzero(sel_pack[g.sel_idx][:, s] == 0)[0])
            lb = -1
            if g.selb_idx >= 0:
                lb = int(np.flatnonzero(sel_pack[g.selb_idx][:, s] == 0)[0])
            out.append((s, la, lb, g.kind, g.jump, g.gate_bit))
    return out


def _hint_lm32(st: PKStatic) -> np.ndarray:
    """The five hint log maluses, rounded to float32 once (as JAX's weak
    typing rounds the Python floats of the reference)."""
    return np.asarray(st.hint_lm, dtype=np.float32)


def _slots_refusal(h) -> Optional[str]:
    if len(h.cross) > MAX_SLOTS or len(h.ex) > MAX_SLOTS:
        return (f"{len(h.cross)} crossing / {len(h.ex)} exact-match hint "
                f"slots (the kernel takes at most {MAX_SLOTS} of each)")
    return None


def _hint_record(h, check: bool = True) -> Tuple[int, ...]:
    """One hinted conv's record: ipo, aL, aR, exclass, K, K2, the window
    rows (HINT_W_ROWS), the x lanes (HINT_X_LANES), then K crossing slots
    (xi start lane, xh weight lane, xi flag lane) and K2 exact-match slots
    (xi position lane, xh weight lane, xi kind lane)."""
    msg = _slots_refusal(h)
    if check and msg:
        raise NotImplementedError(msg)
    rec = [h.ipo, int(h.aL), int(h.aR), h.exclass, len(h.cross), len(h.ex)]
    rec += [getattr(h, k) for k in HINT_W_ROWS + HINT_X_LANES]
    for slot in h.cross + h.ex:
        rec += list(slot)
    return tuple(rec)


def _convh_width(st: PKStatic) -> int:
    """sp_convH lanes in use (the kernel stages only these)."""
    w = 0
    for cv in st.convs:
        for v in cv.variants:
            w = max(w, v.hv_base + v.width if v.hv_base >= 0
                    else v.h_lane + 1)
    return w


def _r4(x: int) -> int:
    return (x + 3) // 4 * 4


def _layout_refusal(st: PKStatic) -> Optional[str]:
    nvar = [len(cv.variants) for cv in st.convs]
    if max(nvar + [0]) > MAX_VAR:
        return f"a conv of {max(nvar)} variants (the kernel takes {MAX_VAR})"
    ipm = [st.gate_lane, st.cls_lane] + [p.eop_lane for p in st.pinned] \
        + [d.jsel_lane for d in st.lessd]
    if max(ipm) >= IPM_W:
        return f"ip_misc lane {max(ipm)} (the kernel stages {IPM_W})"
    return None


def _bytes_refusal(lay: Dict[str, int]) -> Optional[str]:
    if lay["bytes"] > SMEM_LIMIT:
        return (f"{lay['bytes']} bytes of shared memory (a block may have "
                f"{SMEM_LIMIT})")
    return None


def smem_layout(st: PKStatic, desc_len: int, nxh: int = 0,
                nxi: int = 0, check: bool = True) -> Dict[str, int]:
    """Where the kernel keeps what in its dynamic shared memory, in 4-byte
    words, and the bytes in all (`bytes`).  With check, raises
    NotImplementedError for a chunk beyond what the kernel holds: more than
    MAX_VAR variants in a conv, ip_misc lanes beyond IPM_W, or more than
    SMEM_LIMIT bytes."""
    msg = _layout_refusal(st)
    if check and msg:
        raise NotImplementedError(msg)
    nvar = [len(cv.variants) for cv in st.convs]
    hints = [cv.hint for cv in st.convs if cv.hint is not None]
    kc = max([len(h.cross) for h in hints] + [0])
    ke = max([len(h.ex) for h in hints] + [0])
    lay = {"st_ipc": 128 + _r4(_convh_width(st))}
    lay["st_ipm"] = lay["st_ipc"] + 64
    lay["st_xh"] = lay["st_ipm"] + IPM_W
    lay["st_xi"] = lay["st_xh"] + nxh
    lay["st_w"] = lay["st_xi"] + nxi
    # X, vstart (MAX_VAR + 1), vlo, accv, acci, acca, then the K and K2
    # slots
    lay["warp_w"] = NX + 5 * MAX_VAR + 1 + 3 * kc + 3 * ke
    lay["kc"], lay["ke"] = kc, ke
    lay["lvw"] = max([d.window for d in st.lessd] + [0])  # lessD table row
    parts = (("desc", desc_len),
             ("lt", 64 * 64), ("ltc", st.C * len(st.chain_states) * 64),
             ("lvl", len(st.lessd) * lay["lvw"]), ("f0", sum(nvar)),
             ("vbuf", 128), ("kind", 64), ("stage", STAGES * lay["st_w"]),
             ("warp", min(len(st.convs), ITEM_WARPS) * lay["warp_w"]),
             ("lpi", 64 * 64), ("lpc", 64),
             ("chi", st.C * len(st.chain_states) * 64),
             ("chc", st.C * len(st.chain_states)))
    words = 0
    for name, size in parts:
        lay[name] = words
        words += _r4(size)
    lay["bytes"] = words * 4
    msg = _bytes_refusal(lay)
    if check and msg:
        raise NotImplementedError(msg)
    return lay


# the layout fields of the descriptor header, in the order of
# csrc/k1_common.cuh (H_LVW .. H_SM_CHC), after the static class count
_LAYOUT_FIELDS = ("lvw", "lt", "ltc", "lvl", "f0", "vbuf",
                  "kind", "stage", "warp", "st_w", "st_ipc", "st_ipm",
                  "st_xh", "st_xi", "warp_w", "kc", "ke", "lpi", "lpc", "chi",
                  "chc")


def _desc_refusal(desc: np.ndarray) -> Optional[str]:
    if desc.shape[0] > MAX_DESC:
        return (f"chunk descriptor of {desc.shape[0]} ints (the kernel "
                f"holds at most {MAX_DESC}): too many hinted convs or hint "
                "slots")
    return None


def _descriptor(st: PKStatic, sel_pack: np.ndarray, nxh: int = 0,
                nxi: int = 0, check: bool = True) -> np.ndarray:
    """The chunk's static structure as one int32 array, with the kernel's
    shared-memory layout (smem_layout) in its header; with check, raises
    NotImplementedError where the kernel cannot hold it (k1_refusal)."""
    fixed = _fixed_lanes(st, sel_pack)
    chain = list(st.chain_states)
    lessd = [(d.state, d.lane, d.window, d.cum_row, d.valid_row, d.stop_row,
              d.lv_off, d.jsel_lane) for d in st.lessd]
    pinned = [(p.state, p.lane, p.eop_lane) for p in st.pinned]
    convs, variants = [], []
    # hint part: the five log maluses as float32 bits, then the records;
    # a conv holds the offset of its record in this part, or -1
    hints: List[int] = []
    if st.NHW:
        hints += _hint_lm32(st).view(np.int32).tolist()
    for cv in st.convs:
        hoff = -1
        if cv.hint is not None:
            hoff = len(hints)
            hints += _hint_record(cv.hint, check)
        convs.append((cv.state, cv.bpl, cv.a_off, cv.lane, cv.frame_mode,
                      cv.ip_lane, len(variants), len(cv.variants), hoff))
        for v in cv.variants:
            variants.append((v.width, v.len_hi, v.lv_off, v.fm_off, v.g3row,
                             v.h_lane, v.hv_base, v.g2row, v.g2_from))
    header = [len(chain), len(fixed), len(lessd), len(pinned), len(convs),
              st.gate_lane, st.cls_lane, st.S, st.NL]
    body: List[int] = []
    offsets = []
    H_LEN = len(header) + 7 + 1 + len(_LAYOUT_FIELDS)
    for part in (chain, fixed, lessd, pinned, convs, variants, hints):
        offsets.append(H_LEN + len(body))
        for e in part:
            body.extend(e if isinstance(e, tuple) else (e,))
    lay = smem_layout(st, H_LEN + len(body), nxh, nxi, check)
    layout = [st.C] + [lay[k] for k in _LAYOUT_FIELDS]
    desc = np.array(header + offsets + layout + body, dtype=np.int32)
    msg = _desc_refusal(desc)
    if check and msg:
        raise NotImplementedError(msg)
    return desc


def k1_refusal(st: PKStatic, sel_pack: np.ndarray, nxh: int = 0,
               nxi: int = 0) -> Optional[str]:
    """Why csrc/viterbi.cu cannot hold a chunk, from its packed static
    alone, or None: the checks that the wrapper makes before any launch
    (hint slots per conv, variants per conv, ip_misc lanes, shared memory,
    descriptor size), in the order it makes them."""
    for cv in st.convs:
        if cv.hint is not None and _slots_refusal(cv.hint):
            return _slots_refusal(cv.hint)
    desc = _descriptor(st, sel_pack, nxh, nxi, check=False)
    return (_layout_refusal(st)
            or _bytes_refusal(smem_layout(st, desc.shape[0], nxh, nxi,
                                          check=False))
            or _desc_refusal(desc))


def packed_widths(arrays) -> Tuple[np.ndarray, int, int]:
    """(sel_pack on the host, xh lanes, xi lanes) of pack_tracks' arrays
    (numpy, or tensors on the device route): what the descriptor of their
    chunk takes."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)
    nxh = len(arrays["m_xh"]) if "m_xh" in arrays else 0
    nxi = len(arrays["m_xi"]) if "m_xi" in arrays else 0
    return host(arrays["sel_pack"]), nxh, nxi


def k1_fits(static: PKStatic, arrays) -> bool:
    """Whether K1 holds the chunk of pack_tracks' (static, arrays); decided
    before any launch, by the checks its wrapper makes (k1_refusal)."""
    return k1_refusal(static, *packed_widths(arrays)) is None


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _last_argmax(score: torch.Tensor) -> Tuple[torch.Tensor, int]:
    best = score.max()
    idx = int(torch.nonzero(score == best)[-1, 0])
    return best, idx


def _hint_quot(h, lm, xh, xi, hw, bob: torch.Tensor, lenv: torch.Tensor):
    """The exonpart/CDSpart/exon/CDS hint quotient of one hinted conv at one
    position over begins b = bob + ipo (reference exonmodel.cc:1769-1860),
    term for term in the operand order of augustus_tpu's scan._hint_quot.
    xh/xi: the position's xh_plane (f32 tensor) and xi_plane (numpy) rows;
    hw: the window rows; lenv: the exon lengths as float32.  A crossing
    slot whose flag is neither 1 nor 2 subtracts +0 from the covering sums
    and is skipped (exact)."""
    lm_ep, lm_cp, lm_ex, lm_cds, lm_loc = lm
    f32 = torch.float32
    c1 = W_PAD - 1 + bob                 # window column of bob - 1

    def WR(name, col):
        return hw[getattr(h, name), col]

    cov_ep, cov_cp = xh[h.x_tx_ep], xh[h.x_tx_cp]
    covc_ep, covc_cp = xh[h.x_txc_ep], xh[h.x_txc_cp]
    for (sl, wl, fl) in h.cross:
        flv = int(xi[fl])
        if flv not in (1, 2):
            continue
        sub = (int(xi[sl]) >= bob).to(f32)
        if flv == 1:
            cov_ep = cov_ep - xh[wl] * sub
            covc_ep = covc_ep - sub
        else:
            cov_cp = cov_cp - xh[wl] * sub
            covc_cp = covc_cp - sub
    crw_ep = WR("w_cr_ep", c1 + 1)
    inside_ep = ((xh[h.x_be_ep] - WR("w_be_ep", c1)) - crw_ep) + cov_ep
    inside_cp = ((xh[h.x_be_cp] - WR("w_be_cp", c1))
                 - WR("w_cr_cp", c1 + 1)) + cov_cp
    ccw_ep = WR("w_cntcr_ep", c1 + 1)
    cin_ep = ((xh[h.x_cntbe_ep] - WR("w_cntbe_ep", c1)) - ccw_ep) + covc_ep
    cin_cp = ((xh[h.x_cntbe_cp] - WR("w_cntbe_cp", c1))
              - WR("w_cntcr_cp", c1 + 1)) + covc_cp
    part_bonus = inside_ep + inside_cp
    nep = cin_ep + cin_cp
    if h.aL:
        part_bonus = part_bonus + 0.5 * (crw_ep - cov_ep)
        nep = nep + (ccw_ep - covc_ep)
    if h.aR:
        part_bonus = part_bonus + 0.5 * (xh[h.x_c2_ep] - cov_ep)
        nep = nep + (xh[h.x_cntc2_ep] - covc_ep)
    quot = part_bonus
    zero = torch.zeros_like(bob, dtype=f32)
    sup_ex, sup_cds = zero, zero
    for (pl, wl, kl) in h.ex:
        pk, wk, kd = int(xi[pl]), xh[wl], int(xi[kl])
        cond = ((bob == pk) & (kd == 1)).to(f32)
        quot = quot + wk * cond
        sup_cds = torch.maximum(sup_cds, cond)
        if h.exclass == 1:
            cond = ((bob == pk) & (kd == 2)).to(f32)
            quot = quot + wk * cond
            sup_ex = torch.maximum(sup_ex, cond)
        elif h.exclass == 3:
            cond = ((bob > pk) & (kd == 3) & (pk > -(1 << 29))).to(f32)
            quot = quot + (0.5 * wk) * cond
            sup_ex = torch.maximum(sup_ex, cond)
    if h.exclass == 2:
        for (sl, wl, fl) in h.cross:
            cond = ((bob == int(xi[sl])) & (int(xi[fl]) == 4)).to(f32)
            quot = quot + (0.5 * xh[wl]) * cond
            sup_ex = torch.maximum(sup_ex, cond)
    quot = quot + lm_ex * (1.0 - sup_ex) + lm_cds * (1.0 - sup_cds)
    d_ep = lenv - (xh[h.x_cnte_ep] - WR("w_cnte_ep", c1))
    d_cp = lenv - (xh[h.x_cnte_cp] - WR("w_cnte_cp", c1))
    quot = quot + torch.where(d_ep > 0, d_ep * lm_ep, zero)
    quot = quot + torch.where(d_cp > 0, d_cp * lm_cp, zero)
    zc = xh[h.x_zc] - WR("w_zc", c1)
    lpm = torch.where(zc > 0, zc * lm_loc, zero)
    lpm = torch.maximum(lpm, -part_bonus)
    return quot + torch.where(nep >= 4.5, lpm, zero)


def conv_quot(cv, j: int, lm, xh, xi, hw):
    """The hint quotient of a hinted conv at position j, a function of
    (j, b): once over the union of the variants' bands, b descending from
    ub1 - 1 to ub0.  (quotient tensor, ub0)."""
    dev = xh.device
    ub0 = min(j + cv.a_off - v.len_hi for v in cv.variants)
    ub1 = max(j + cv.a_off - v.len_hi + v.width for v in cv.variants)
    bu = torch.arange(ub0, ub1, device=dev)
    return _hint_quot(cv.hint, lm, xh, xi, hw, bu - cv.hint.ipo,
                      (j + cv.a_off - bu).to(torch.float32)), ub0


def band_score(cv, var, j: int, phi: int, smin: int, smax: int,
               hv: torch.Tensor, gc: torch.Tensor, lv: torch.Tensor,
               lv_h: np.ndarray, sph: torch.Tensor, quot=None):
    """The score of every entry w of one variant's band of an exon
    convolution at position j (begin b = j + a_off - len_hi + w), NEG where
    masked, begins outside [smin, smax] included, and the lane offset
    (frame) of each entry: (score, frames).  hv: the lane history,
    position-major with W_PAD rows of front padding; gc: gcum of the
    position's class; sph: its sp_convH row; quot: conv_quot's result for
    a hinted conv."""
    dev = hv.device
    wd = var.width
    b0 = j + cv.a_off - var.len_hi
    r0 = b0 - cv.bpl - 1
    widx = torch.arange(wd, device=dev)
    fl = torch.zeros(wd, dtype=torch.int64, device=dev)
    if cv.frame_mode:
        f0 = 0 if lv_h[var.fm_off] > 0.5 else \
            (1 if lv_h[var.fm_off + wd] > 0.5 else 2)
        sgn = 1 if cv.frame_mode == 1 else -1
        fl = torch.remainder(f0 + sgn * widx, 3)
        L = hv[W_PAD + r0 + widx, cv.lane + fl]
    else:
        L = hv[W_PAD + r0: W_PAD + r0 + wd, cv.lane]
    G = gc[var.g3row + phi, W_PAD + b0: W_PAD + b0 + wd]
    if var.g2row >= 0:
        G2 = gc[var.g2row + phi, W_PAD + b0: W_PAD + b0 + wd]
        G = torch.where(widx >= var.g2_from, G2, G)
    lvd = lv[var.lv_off: var.lv_off + wd]
    bvec = b0 + widx
    okb = (bvec >= smin) & (bvec <= smax)
    base = (L + G) + lvd
    if quot is not None:
        quot_u, ub0 = quot
        base = base + quot_u[b0 - ub0: b0 - ub0 + wd]
    negt = torch.tensor(NEG, dtype=torch.float32, device=dev)
    if var.hv_base >= 0:
        Hv = sph[var.hv_base: var.hv_base + wd]
        return torch.where(okb & (L > GATE) & (G > GATE) & (Hv > GATE),
                           base + Hv, negt), fl
    return torch.where(okb & (L > GATE) & (G > GATE), base, negt), fl


def variant_best(var, sbest: torch.Tensor, sph: torch.Tensor) -> torch.Tensor:
    """A variant's value from its band's best score: the band's own H
    lanes were added per entry, else the scalar H is added here."""
    negt = torch.tensor(NEG, dtype=torch.float32, device=sbest.device)
    if var.hv_base >= 0:
        return torch.where(sbest > GATE, sbest, negt)
    H = sph[var.h_lane]
    return torch.where((sbest > GATE) & (H > GATE), sbest + H, negt)


def viterbi_forward_reference(static: PKStatic, planes: Dict[str, torch.Tensor],
                              debug_vals: bool = False):
    """The kernel's function as an eager loop over positions (same operand
    order, same tie rules, float32).  Gates and indices are read on the
    host from the integer planes; all float arithmetic runs in torch on the
    planes' device."""
    st = static
    n, S, NL = st.n, st.S, st.NL
    dev = planes["sp_state"].device
    f32 = torch.float32
    NEGt = torch.tensor(NEG, dtype=f32, device=dev)
    GATEt = torch.tensor(GATE, dtype=f32, device=dev)
    sps_all, spg_all = planes["sp_state"], planes["sp_geo"]
    sph_all, gcum, msk = planes["sp_convH"], planes["gcum"], planes["msk"]
    lv = planes["lv_pack"].reshape(-1)
    ltc = planes["ltc_all"][:, :S, :S]             # (C, p, s)
    ltr = planes["lt_T"][:S, :NL].t()              # (l, p)
    ipm_h = planes["ip_misc"][:n].cpu().numpy()
    ipc_h = planes["ip_conv"][:n].cpu().numpy()
    lv_h = planes["lv_pack"].reshape(-1).cpu().numpy()
    fixed = _fixed_lanes(st, planes["sel_pack"].cpu().numpy())
    if st.NHW:
        lm = torch.from_numpy(_hint_lm32(st)).to(dev).unbind()
        xh_all, hw = planes["xh_plane"], planes["hw_rows"]
        xi_h = planes["xi_plane"][:n].cpu().numpy()

    # lane history, position-major with W_PAD rows of front padding
    hv = torch.empty((W_PAD + n, NL), dtype=f32, device=dev)
    ha = torch.empty((W_PAD + n, NL), dtype=torch.int64, device=dev)
    hv[:W_PAD] = planes["l0"].reshape(-1)[:NL]
    ha[:W_PAD] = planes["a0"].reshape(-1)[:NL].long()

    bp = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    vals = torch.full((n, 64), NEG, dtype=f32, device=dev) \
        if debug_vals else None
    v = planes["v0"].reshape(-1).clone()
    if debug_vals:
        vals[0] = v

    def lane_update(j, v):
        cand = v[None, :S] + ltr                       # (NL, S)
        m = cand.max(dim=1).values
        hv[W_PAD + j] = m
        ha[W_PAD + j] = torch.argmax(
            (cand == m[:, None]).to(torch.int8), dim=1)   # first argmax

    lane_update(0, v)
    for j in range(1, n):
        c = int(ipm_h[j, st.cls_lane])
        ipm, ipc = ipm_h[j], ipc_h[j]
        sps, spg, sph = sps_all[j], spg_all[j], sph_all[j]
        gc = gcum[c]
        vnew = torch.full((64,), NEG, dtype=f32, device=dev)
        pred = torch.zeros(64, dtype=torch.int64, device=dev)
        off = torch.zeros(64, dtype=torch.int64, device=dev)

        # chain states: first argmax over predecessors
        cs = list(st.chain_states)
        cand = v[:S, None] + ltc[c][:, cs]             # (S, nchain)
        m = cand.max(dim=0).values
        arg = torch.argmax((cand == m[None, :]).to(torch.int8), dim=0)
        vnew[cs] = torch.where(m > GATEt, m + sps[cs], NEGt)
        pred[cs] = arg
        off[cs] = 1

        # fixed-jump states
        gbits = int(ipm[st.gate_lane])
        for (s, la_, lb_, kind, jump, gbit) in fixed:
            if not (gbits >> gbit) & 1:
                continue
            r = W_PAD + j - jump
            lvv = hv[r, la_]
            la = ha[r, la_]
            if kind == 1:
                lvv = lvv + spg[s]
            elif kind == 2:
                lvB = hv[r, lb_] + spg[s]
                la = torch.where(lvB > lvv, ha[r, lb_], la)
                lvv = torch.maximum(lvv, lvB)
            ok = bool((lvv > GATEt) & (sps[s] > GATEt))
            if ok:
                vnew[s] = lvv + sps[s]
                pred[s] = la
                off[s] = jump

        # lessD introns: last argmax over the window
        for d in st.lessd:
            s, W5 = d.state, d.window
            psi = sps[s]
            if not bool(psi > GATEt):
                off[s] = 1
                continue
            r0 = j - W5
            rr = slice(W_PAD + r0, W_PAD + j)
            Lsh = hv[rr, d.lane]
            seg = gc[d.cum_row, W_PAD + j] - gc[d.cum_row, rr]
            jsel = int(ipm[d.jsel_lane])
            ok = (torch.arange(r0, j, device=dev) >= 0) & \
                (msk[d.valid_row, rr] != 0) & \
                ((msk[d.stop_row, rr] & jsel) == 0)
            lvd = lv[d.lv_off: d.lv_off + W5]
            score = torch.where(ok & (Lsh > GATEt),
                                ((Lsh + seg) + lvd) + psi, NEGt)
            best, ridx = _last_argmax(score)
            vnew[s] = torch.where(best > GATEt, best, NEGt)
            pred[s] = ha[W_PAD + r0 + ridx, d.lane]
            off[s] = W5 - ridx

        # pinned (ORF-bounded) states
        for p in st.pinned:
            s = p.state
            sc = sps[s]
            off[s] = 1
            if not bool(sc > GATEt):
                continue
            eop = int(ipm[p.eop_lane])
            r = W_PAD + max(eop, -W_PAD)
            lvv = hv[r, p.lane]
            vnew[s] = torch.where(lvv > GATEt, lvv + sc, NEGt)
            pred[s] = ha[r, p.lane]
            off[s] = j - eop

        # exon convolutions: banded max-plus, last argmax, first variant
        # wins ties between variants
        for cv in st.convs:
            s = cv.state
            gp = int(ipc[cv.ip_lane])
            off[s] = 1
            if not gp & 1:
                continue
            phi = gp >> 1
            smin, smax = int(ipc[cv.ip_lane + 1]), int(ipc[cv.ip_lane + 2])
            quot = None
            if cv.hint is not None:
                quot = conv_quot(cv, j, lm, xh_all[j], xi_h[j], hw)
            best = NEGt
            for var in cv.variants:
                score, fl = band_score(cv, var, j, phi, smin, smax, hv, gc,
                                       lv, lv_h, sph, quot)
                sbest, ridx = _last_argmax(score)
                vbest = variant_best(var, sbest, sph)
                if bool(vbest > best):
                    best = vbest
                    r0 = j + cv.a_off - var.len_hi - cv.bpl - 1
                    pred[s] = ha[W_PAD + r0 + ridx, cv.lane + int(fl[ridx])]
                    off[s] = (var.len_hi - cv.a_off + cv.bpl + 1) - ridx
            vnew[s] = best

        bp[j] = (pred << 20) | off
        if debug_vals:
            vals[j] = vnew
        v = vnew
        lane_update(j, v)
    return bp.to(torch.int32), v, vals


# --------------------------------------------------------------------------
# the wrapper: kernel on CUDA tensors, plain version on CPU tensors
# --------------------------------------------------------------------------


_PLANE_SPECS = {       # name -> (dtype, trailing shape or None)
    "sp_state": (torch.float32, (128,)), "sp_geo": (torch.float32, (128,)),
    "sp_convH": (torch.float32, (256,)), "ip_conv": (torch.int32, (128,)),
    "ip_misc": (torch.int32, (128,)), "gcum": (torch.float32, None),
    "msk": (torch.int32, None), "ltc_all": (torch.float32, (64, 64)),
    "lt_T": (torch.float32, (64, 64)), "sel_pack": (torch.float32, (64, 64)),
    "lv_pack": (torch.float32, None), "v0": (torch.float32, (64,)),
    "l0": (torch.float32, (64,)), "a0": (torch.int32, (64,)),
}


_HINT_PLANE_SPECS = {"xh_plane": (torch.float32, None),
                     "xi_plane": (torch.int32, None),
                     "hw_rows": (torch.float32, None)}


def _check(static: PKStatic, planes: Dict[str, torch.Tensor]) -> torch.device:
    if static.S > 64 or static.NL > 64:
        raise NotImplementedError("more than 64 states or lanes")
    dev = planes["sp_state"].device
    specs = dict(_PLANE_SPECS)
    if static.NHW:
        missing = [k for k in _HINT_PLANE_SPECS if k not in planes]
        if missing:
            raise ValueError(f"a chunk with sparse hints needs the planes "
                             f"{missing}")
        specs.update(_HINT_PLANE_SPECS)
    for k, (dt, tail) in specs.items():
        t = planes[k]
        if t.device != dev:
            raise ValueError(f"plane {k} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise ValueError(f"plane {k} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"plane {k} is not contiguous")
        if tail is not None and tuple(t.shape[-len(tail):]) != tail:
            raise ValueError(f"plane {k} has shape {tuple(t.shape)}")
    for k in ("sp_state", "sp_geo", "sp_convH", "ip_conv", "ip_misc"):
        if planes[k].shape[0] < static.n:
            raise ValueError(f"plane {k} has fewer than n={static.n} rows")
    gw = W_PAD + static.n_pad + 640
    if tuple(planes["gcum"].shape) != (static.C, static.NGR, gw):
        raise ValueError(f"gcum has shape {tuple(planes['gcum'].shape)}")
    if tuple(planes["msk"].shape) != (static.NMS, gw):
        raise ValueError(f"msk has shape {tuple(planes['msk'].shape)}")
    if tuple(planes["ltc_all"].shape[:1]) != (static.C,):
        raise ValueError("ltc_all does not have one matrix per GC class")
    if static.NHW:
        if tuple(planes["hw_rows"].shape) != (static.NHW, gw):
            raise ValueError(f"hw_rows has shape "
                             f"{tuple(planes['hw_rows'].shape)}")
        for k in ("xh_plane", "xi_plane"):
            if planes[k].dim() != 2 or planes[k].shape[0] < static.n:
                raise ValueError(f"plane {k} has shape "
                                 f"{tuple(planes[k].shape)}")
    # what the kernel holds (variants, shared memory), on every
    # device, so that the CPU refuses what the card would
    _descriptor(static, planes["sel_pack"].cpu().numpy(), *_hint_widths(
        static, planes))
    return dev


def _hint_widths(static: PKStatic, planes: Dict[str, torch.Tensor]):
    """(xh lanes, xi lanes) of a hinted chunk's planes, else (0, 0)."""
    if not static.NHW:
        return 0, 0
    return planes["xh_plane"].shape[1], planes["xi_plane"].shape[1]


def viterbi_forward(static: PKStatic, planes: Dict[str, torch.Tensor],
                    debug_vals: bool = False):
    """(bp (n,64) int32, v_final (64,) float32, vals (n,64) float32 | None)
    of the plain version, on CPU tensors."""
    dev = _check(static, planes)
    if dev.type != "cpu":
        raise ValueError(f"the reference runs on the CPU, not {dev}")
    return viterbi_forward_reference(static, planes, debug_vals)


def planes_for(static: PKStatic, arrays: Dict[str, np.ndarray],
               device) -> Dict[str, torch.Tensor]:
    """Compact arrays -> device tensors -> expanded kernel planes."""
    a = to_device(arrays, device)
    planes = expand_arrays(static, a)
    for k in KERNEL_CONSTANTS:
        planes[k] = a[k]
    return planes


class ViterbiEngine:
    """Pack one chunk's tracks, run the forward pass on `device`, and walk
    the backpointers (the port's counterpart of PallasEngine).  `packed`:
    pack_tracks' result when the caller packed already (the device route
    packs on the card)."""

    def __init__(self, tracks: DPTracks, device, packed=None):
        self.tracks = tracks
        self.device = torch.device(device)
        self.static, self.arrays = packed if packed is not None \
            else pack_tracks(tracks)
        self.n, self.S = self.static.n, self.static.S

    def inputs(self) -> Dict[str, torch.Tensor]:
        """The kernel's planes on the engine's device (stage `expand`)."""
        from .. import stats
        with stats.stage("expand", self.device):
            return planes_for(self.static, self.arrays, self.device)

    def run(self, debug_vals: bool = False) -> None:
        from .. import stats
        planes = self.inputs()
        with stats.stage("kernel", self.device):
            self.bp, vfin, self.vals = viterbi_forward(self.static, planes,
                                                       debug_vals)
        vf = np.full(self.tracks.S, NEG, dtype=np.float32)
        vf[: self.S] = vfin[: self.S].cpu().numpy()
        self.v_final = vf

    def _walk_start(self) -> int:
        last = self.v_final + np.asarray(self.tracks.log_term)
        state = int(np.argmax(last))
        if last[state] <= float(NEG) / 2:
            raise RuntimeError("No feasible path found in HMM")
        return state

    def trace_packed(self) -> Tuple[np.ndarray, int]:
        from .traceback import trace_packed
        return trace_packed(self.bp.cpu().numpy(), self._walk_start(),
                            self.n)

    def traceback(self):
        from .traceback import raw_segments
        packed, fb = self.trace_packed()
        return raw_segments(packed, fb, self.tracks.gold.sg.state_types)

    def traceback_path(self, dnalen: int):
        """The condensed path by the event walk K4 over the plane where the
        kernel left it (on the card only the events come back)."""
        from .traceback import path_by_events
        return path_by_events(self.bp, self._walk_start(), self.n, dnalen,
                              self.tracks.gold.sg.state_types)
