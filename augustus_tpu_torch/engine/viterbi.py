"""Semi-Markov Viterbi forward pass: CUDA kernel, plain version, engine.

`viterbi_forward` replaces the Pallas TPU kernel
`augustus_tpu/engine/pallas_scan.py:make_kernel` (launched by `build_call`,
driven by `make_pallas_fn` / `PallasEngine`) for chunks without sparse
exon/CDS hints.  On a CUDA tensor it launches `csrc/viterbi.cu`; on a CPU
tensor it runs `viterbi_forward_reference`, the plain PyTorch version with
the same arithmetic (an eager loop over positions).

What bounds the kernel on the card: the recursion is sequential over the n
positions of a chunk (position j reads the values of j-1 and the lane
history of older positions), so one chunk runs in one thread block on one
SM; per position it reads one row of each plane (about 3.6 KB) and the
convolution windows, which stay in L2.  The design answers that with one
block per chunk, a loop over positions inside the kernel, and the lane
history lane-major in global memory so window reads are coalesced.  Making
it fast (several chunks across SMs, shared-memory staging) is later work.

Outputs, for positions j = 0 .. n-1 and states s < 64:
  bp     (n, 64) int32   packed backpointer (pred << 20) | off; row j is the
                         reference scan's bps[j-1]; row 0 is 0
  v_final (64,) float32  Viterbi values at n-1
  vals   (n, 64) float32 per-step values (debug_vals=True); row 0 is v0
States gated off at j get value NEG and a backpointer that is never read
(off 0 for fixed-jump states, pred 0 / off 1 otherwise).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from .device import DPTracks, F32_NEG
from .pack import (KERNEL_CONSTANTS, W_PAD, PKStatic, expand_arrays,
                   pack_tracks, to_device)

NEG = np.float32(F32_NEG)
GATE = np.float32(-1.0e29)
MAX_DESC = 2048


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


def _descriptor(st: PKStatic, sel_pack: np.ndarray) -> np.ndarray:
    fixed = _fixed_lanes(st, sel_pack)
    chain = list(st.chain_states)
    lessd = [(d.state, d.lane, d.window, d.cum_row, d.valid_row, d.stop_row,
              d.lv_off, d.jsel_lane) for d in st.lessd]
    pinned = [(p.state, p.lane, p.eop_lane) for p in st.pinned]
    convs, variants = [], []
    for cv in st.convs:
        convs.append((cv.state, cv.bpl, cv.a_off, cv.lane, cv.frame_mode,
                      cv.ip_lane, len(variants), len(cv.variants)))
        for v in cv.variants:
            variants.append((v.width, v.len_hi, v.lv_off, v.fm_off, v.g3row,
                             v.h_lane, v.hv_base, v.g2row, v.g2_from))
    header = [len(chain), len(fixed), len(lessd), len(pinned), len(convs),
              st.gate_lane, st.cls_lane, st.S, st.NL]
    body: List[int] = []
    offsets = []
    H_LEN = len(header) + 6
    for part in (chain, fixed, lessd, pinned, convs, variants):
        offsets.append(H_LEN + len(body))
        for e in part:
            body.extend(e if isinstance(e, tuple) else (e,))
    desc = np.array(header + offsets + body, dtype=np.int32)
    if desc.shape[0] > MAX_DESC:
        raise NotImplementedError(f"chunk descriptor of {desc.shape[0]} ints")
    return desc


def kernel_work(static: PKStatic, planes: Dict[str, torch.Tensor]):
    """What one launch must move and compute on this chunk's data, for the
    roofline bound: ({part: bytes}, float ops).

    Bytes count each input element that the kernel reads for these inputs
    once (rows 1..n-1 of the j-planes, only the lanes the descriptor names
    and only where their gate is on; the gcum/msk columns that the windows
    cover; the constant tables), each output element written once (bp and
    v_final; the debug values are not part of a timed launch), and the lane
    history written once (`scratch`: NL lanes of value and arg per
    position; its window reads are not counted again).  Ops count the
    float adds and max-compares: per predecessor of a chain state or lane,
    one add and one max; per window entry, the score's adds and one max."""
    st = static
    n, S, NL = st.n, st.S, st.NL
    host = {k: planes[k].cpu().numpy() for k in
            ("ip_misc", "ip_conv", "sp_state", "msk", "sel_pack")}
    ipm, ipc = host["ip_misc"][1:n], host["ip_conv"][1:n]
    sps, msk = host["sp_state"][1:n], host["msk"]
    J = np.arange(1, n)
    cls = ipm[:, st.cls_lane]
    gw = planes["gcum"].shape[-1]
    read = {k: np.zeros((n - 1, planes[k].shape[1]), dtype=bool) for k in
            ("sp_state", "sp_geo", "sp_convH", "ip_conv", "ip_misc")}
    gdiff = np.zeros((st.C, st.NGR, gw + 1), dtype=np.int64)
    mread = np.zeros(msk.shape, dtype=bool)
    lv_used = np.zeros(planes["lv_pack"].numel(), dtype=bool)
    ops = 0

    def cover(c, row, start, end):          # gcum columns [start, end)
        keep = end > start
        np.add.at(gdiff, (c[keep], row[keep], start[keep]), 1)
        np.add.at(gdiff, (c[keep], row[keep], end[keep]), -1)

    read["ip_misc"][:, st.cls_lane] = True
    cs = list(st.chain_states)
    read["sp_state"][:, cs] = True
    ops += (n - 1) * len(cs) * S * 2 + n * NL * S * 2
    for (s, _, _, kind, _, gbit) in _fixed_lanes(st, host["sel_pack"]):
        read["ip_misc"][:, st.gate_lane] = True
        on = ((ipm[:, st.gate_lane] >> gbit) & 1).astype(bool)
        read["sp_state"][on, s] = True
        if kind in (1, 2):
            read["sp_geo"][on, s] = True
        ops += int(on.sum()) * (1 + (kind >= 1) + (kind == 2))
    for p in st.pinned:
        read["sp_state"][:, p.state] = True
        on = sps[:, p.state] > GATE
        read["ip_misc"][on, p.eop_lane] = True
        ops += int(on.sum())
    for d in st.lessd:
        read["sp_state"][:, d.state] = True
        on = sps[:, d.state] > GATE
        read["ip_misc"][on, d.jsel_lane] = True
        jj = J[on]
        cover(cls[on], np.full(jj.shape, d.cum_row), W_PAD + jj - d.window,
              W_PAD + jj + 1)
        rng = np.zeros(gw + 1, dtype=np.int64)
        np.add.at(rng, W_PAD + np.maximum(jj - d.window, 0), 1)
        np.add.at(rng, W_PAD + jj, -1)
        span = np.cumsum(rng)[:gw] > 0
        mread[d.valid_row] |= span
        mread[d.stop_row] |= span & (msk[d.valid_row] != 0)
        lv_used[d.lv_off: d.lv_off + d.window] = True
        ops += int(on.sum()) * d.window * 5
    for cv in st.convs:
        read["ip_conv"][:, cv.ip_lane] = True
        gp = ipc[:, cv.ip_lane]
        on = (gp & 1).astype(bool)
        read["ip_conv"][on, cv.ip_lane + 1: cv.ip_lane + 3] = True
        jj, c, phi = J[on], cls[on], gp[on] >> 1
        for v in cv.variants:
            b0 = W_PAD + jj + cv.a_off - v.len_hi
            w1 = min(max(v.g2_from, 0), v.width) if v.g2row >= 0 else v.width
            cover(c, v.g3row + phi, b0, b0 + w1)
            if v.g2row >= 0:
                cover(c, v.g2row + phi, b0 + w1, b0 + v.width)
            if v.hv_base >= 0:
                read["sp_convH"][on, v.hv_base: v.hv_base + v.width] = True
            else:
                read["sp_convH"][on, v.h_lane] = True
            lv_used[v.lv_off: v.lv_off + v.width] = True
            if cv.frame_mode:
                lv_used[[v.fm_off, v.fm_off + v.width]] = True
            ops += int(on.sum()) * v.width * (3 + (v.hv_base >= 0))
    n_cls = len(np.unique(cls)) if n > 1 else 0
    parts = {k: int(m.sum()) * 4 for k, m in read.items()}
    parts["gcum"] = int((np.cumsum(gdiff, axis=-1)[..., :gw] > 0).sum()) * 4
    parts["msk"] = int(mread.sum()) * 4
    parts["tables"] = (n_cls * len(cs) * S + NL * S + int(lv_used.sum())
                       + 3 * 64) * 4 + _descriptor(st, host["sel_pack"]).nbytes
    parts["outputs"] = (n * 64 + 64) * 4
    parts["scratch"] = n * NL * 8
    return parts, ops


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _last_argmax(score: torch.Tensor) -> Tuple[torch.Tensor, int]:
    best = score.max()
    idx = int(torch.nonzero(score == best)[-1, 0])
    return best, idx


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
            best = NEGt
            for var in cv.variants:
                wd = var.width
                b0 = j + cv.a_off - var.len_hi
                r0 = b0 - cv.bpl - 1
                widx = torch.arange(wd, device=dev)
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
                if var.hv_base >= 0:
                    Hv = sph[var.hv_base: var.hv_base + wd]
                    score = torch.where(okb & (L > GATEt) & (G > GATEt)
                                        & (Hv > GATEt), base + Hv, NEGt)
                    sbest, ridx = _last_argmax(score)
                    vbest = torch.where(sbest > GATEt, sbest, NEGt)
                else:
                    score = torch.where(okb & (L > GATEt) & (G > GATEt),
                                        base, NEGt)
                    sbest, ridx = _last_argmax(score)
                    H = sph[var.h_lane]
                    vbest = torch.where((sbest > GATEt) & (H > GATEt),
                                        sbest + H, NEGt)
                if bool(vbest > best):
                    f = 0
                    if cv.frame_mode:
                        f = (f0 + sgn * ridx) % 3
                    best = vbest
                    pred[s] = ha[W_PAD + r0 + ridx, cv.lane + f]
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

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] + [ctypes.c_void_p] * 5 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]

_PLANE_SPECS = {       # name -> (dtype, trailing shape or None)
    "sp_state": (torch.float32, (128,)), "sp_geo": (torch.float32, (128,)),
    "sp_convH": (torch.float32, (256,)), "ip_conv": (torch.int32, (128,)),
    "ip_misc": (torch.int32, (128,)), "gcum": (torch.float32, None),
    "msk": (torch.int32, None), "ltc_all": (torch.float32, (64, 64)),
    "lt_T": (torch.float32, (64, 64)), "sel_pack": (torch.float32, (64, 64)),
    "lv_pack": (torch.float32, None), "v0": (torch.float32, (64,)),
    "l0": (torch.float32, (64,)), "a0": (torch.int32, (64,)),
}


def _check(static: PKStatic, planes: Dict[str, torch.Tensor]) -> torch.device:
    if getattr(static, "NHW", 0):
        raise NotImplementedError(
            "sparse exon/CDS hints (K1.f hint_quot of the TPU kernel) are "
            "not ported yet")
    if static.S > 64 or static.NL > 64:
        raise NotImplementedError("more than 64 states or lanes")
    dev = planes["sp_state"].device
    for k, (dt, tail) in _PLANE_SPECS.items():
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
    return dev


def viterbi_forward(static: PKStatic, planes: Dict[str, torch.Tensor],
                    debug_vals: bool = False):
    """(bp (n,64) int32, v_final (64,) float32, vals (n,64) float32 | None).

    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    raise if it does not build or launch).  `viterbi_forward.launches`
    counts kernel launches."""
    dev = _check(static, planes)
    if dev.type == "cpu":
        return viterbi_forward_reference(static, planes, debug_vals)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import load
    lib = load("viterbi")
    fn = lib.viterbi_forward_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = static.n
    desc = torch.from_numpy(
        _descriptor(static, planes["sel_pack"].cpu().numpy())).to(dev)
    ltcT = planes["ltc_all"].transpose(1, 2).contiguous()     # [c][s][p]
    lane_tr = planes["lt_T"].t().contiguous()                 # [l][p]
    hs = W_PAD + n
    hist_v = torch.empty((64, hs), dtype=torch.float32, device=dev)
    hist_a = torch.empty((64, hs), dtype=torch.int32, device=dev)
    bp = torch.empty((n, 64), dtype=torch.int32, device=dev)
    vals = torch.empty((n, 64), dtype=torch.float32, device=dev) \
        if debug_vals else None
    v_final = torch.empty(64, dtype=torch.float32, device=dev)
    gw = planes["gcum"].shape[-1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = planes
    err = fn(p["sp_state"].data_ptr(), p["sp_geo"].data_ptr(),
             p["sp_convH"].data_ptr(), p["ip_conv"].data_ptr(),
             p["ip_misc"].data_ptr(), p["gcum"].data_ptr(),
             p["msk"].data_ptr(), ltcT.data_ptr(), lane_tr.data_ptr(),
             p["lv_pack"].data_ptr(), p["v0"].data_ptr(),
             p["l0"].data_ptr(), p["a0"].data_ptr(), desc.data_ptr(),
             int(desc.shape[0]), hist_v.data_ptr(), hist_a.data_ptr(),
             bp.data_ptr(), vals.data_ptr() if vals is not None else None,
             v_final.data_ptr(), n, static.NGR, gw, hs, stream)
    if err != 0:
        raise RuntimeError(f"viterbi_forward kernel launch failed: CUDA "
                           f"error {err}")
    viterbi_forward.launches += 1
    return bp, v_final, vals


viterbi_forward.launches = 0


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
    the backpointers (the port's counterpart of PallasEngine)."""

    def __init__(self, tracks: DPTracks, device):
        self.tracks = tracks
        self.device = torch.device(device)
        self.static, self.arrays = pack_tracks(tracks)
        self.n, self.S = self.static.n, self.static.S

    def run(self, debug_vals: bool = False) -> None:
        from .. import stats
        with stats.stage("expand", self.device):
            planes = planes_for(self.static, self.arrays, self.device)
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
        from .traceback import condensed_path
        packed, fb = self.trace_packed()
        return condensed_path(packed, fb, dnalen,
                              self.tracks.gold.sg.state_types)
