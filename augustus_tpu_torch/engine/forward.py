"""Semi-Markov forward table (logsumexp): CUDA kernel, plain version, engine.

`forward_table` replaces the JAX package's device forward pass K3,
`augustus_tpu/engine/scan.py:make_forward_fn` with its sparse exon/CDS hint
quotient `_hint_quot` (scan.py:419-500), driven by `ForwardEngine`
(scan.py:937).  It is the Viterbi recursion of engine/viterbi.py with every
maximum replaced by a logsumexp and no backpointers.  On a CUDA tensor it
launches `csrc/forward.cu`; on a CPU tensor it runs `forward_reference`,
the plain PyTorch version (an eager loop over positions).

It reads the same planes as the Viterbi kernel (pack_tracks +
expand_arrays), from `pack.forward_arrays`: the log tables heated for
--temperature and the initial lane values `l0` as a logsumexp.

A logsumexp over candidates x is the two-pass form of the reference's
`lse_vec`: m = max(x); s = sum of exp(x - m) over the x > GATE; m + log(s)
when m > GATE, else NEG.  Candidates at or below GATE add nothing, so the
kernel may leave out any it can prove to be there.  Sums run in another
order than in augustus_tpu (and in the kernel than here), so tables agree
within a tolerance, not bit for bit (tests/test_torch_forward.py).

What bounds the kernel on the card: as for the Viterbi kernel, the
sequential dependence between positions (one thread block per chunk), each
position waiting on the latency of its slowest item.  Every
candidate of a logsumexp is built once and kept in registers for both
passes, the chain states of the next position run beside the lane update,
and the block has K3_WARPS warps (csrc/forward.cu's header says why); the
table is bit-equal to the earlier two-pass design's (the K3_TWO_PASS
build).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from .device import DPTracks, F32_NEG
from .pack import PKStatic, forward_arrays, pack_tracks
from .viterbi import (GATE, NEG, W_PAD, _check, _descriptor, _fixed_lanes,
                      _hint_lm32, _hint_widths, band_score, conv_quot,
                      kernel_work, planes_for, smem_layout, variant_best)


def _lse(x: torch.Tensor, dim: int = -1):
    """logsumexp over `dim` with the GATE filter, and the count of exp and
    log evaluations it needs (entries > GATE; one log per result whose
    maximum is > GATE), as a tensor on x's device."""
    m = x.max(dim=dim, keepdim=True).values
    live = x > GATE
    s = torch.where(live, torch.exp(x - m), torch.zeros_like(x)).sum(dim=dim)
    m = m.squeeze(dim)
    ok = m > GATE
    out = torch.where(ok, m + torch.log(s), torch.full_like(m, float(NEG)))
    return out, live.sum() + ok.sum()


def _lse2(a: torch.Tensor, b: torch.Tensor):
    return _lse(torch.stack([a, b]), 0)


def forward_reference(static: PKStatic, planes: Dict[str, torch.Tensor]):
    """The kernel's function as an eager loop over positions, term for term
    in the order of augustus_tpu's make_forward_fn: per variant of a conv a
    logsumexp over its band, then a two-term one into the conv's value (a
    merged narrow-variant band holds each column's own H lane).  Returns
    (rows (n, 64) float32, row 0 = v0; the count of exp and log
    evaluations over live candidates)."""
    st = static
    n, S, NL = st.n, st.S, st.NL
    dev = planes["sp_state"].device
    f32 = torch.float32
    NEGt = torch.tensor(NEG, dtype=f32, device=dev)
    sps_all, spg_all = planes["sp_state"], planes["sp_geo"]
    sph_all, gcum, msk = planes["sp_convH"], planes["gcum"], planes["msk"]
    lv = planes["lv_pack"].reshape(-1)
    ltc = planes["ltc_all"][:, :S, :S]             # (C, p, s)
    ltr = planes["lt_T"][:S, :NL].t()              # (l, p)
    ipm_h = planes["ip_misc"][:n].cpu().numpy()
    ipc_h = planes["ip_conv"][:n].cpu().numpy()
    lv_h = lv.cpu().numpy()
    sps_h = sps_all[:n].cpu().numpy()
    fixed = _fixed_lanes(st, planes["sel_pack"].cpu().numpy())
    if st.NHW:
        lm = torch.from_numpy(_hint_lm32(st)).to(dev).unbind()
        xh_all, hw = planes["xh_plane"], planes["hw_rows"]
        xi_h = planes["xi_plane"][:n].cpu().numpy()

    hv = torch.empty((W_PAD + n, NL), dtype=f32, device=dev)
    hv[:W_PAD] = planes["l0"].reshape(-1)[:NL]
    rows = torch.full((n, 64), NEG, dtype=f32, device=dev)
    v = planes["v0"].reshape(-1).clone()
    rows[0] = v
    sfu = torch.zeros((), dtype=torch.int64, device=dev)

    def lane_update(j, v):
        val, k = _lse(v[None, :S] + ltr, 1)              # (NL,)
        hv[W_PAD + j] = val
        return k

    sfu += lane_update(0, v)
    cs = list(st.chain_states)
    for j in range(1, n):
        c = int(ipm_h[j, st.cls_lane])
        ipm, ipc = ipm_h[j], ipc_h[j]
        sps, spg, sph = sps_all[j], spg_all[j], sph_all[j]
        gc = gcum[c]
        vnew = torch.full((64,), NEG, dtype=f32, device=dev)

        # chain states: logsumexp over every predecessor
        cand, k = _lse(v[:S, None] + ltc[c][:, cs], 0)
        sfu += k
        vnew[cs] = torch.where(cand > GATE, cand + sps[cs], NEGt)

        # fixed-jump states (kind 2: two lanes, logsumexp)
        gbits = int(ipm[st.gate_lane])
        for (s, la_, lb_, kind, jump, gbit) in fixed:
            if not (gbits >> gbit) & 1:
                continue
            r = W_PAD + j - jump
            lvv = hv[r, la_]
            if kind == 1:
                lvv = lvv + spg[s]
            elif kind == 2:
                lvv, k = _lse2(lvv, hv[r, lb_] + spg[s])
                sfu += k
            if bool((lvv > GATE) & (sps[s] > GATE)):
                vnew[s] = lvv + sps[s]

        # lessD introns: logsumexp over the window
        for d in st.lessd:
            s, W5 = d.state, d.window
            psi = sps[s]
            if not sps_h[j, s] > GATE:
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
            score = torch.where(ok & (Lsh > GATE),
                                ((Lsh + seg) + lvd) + psi, NEGt)
            vnew[s], k = _lse(score)
            sfu += k

        # pinned (ORF-bounded) states
        for p in st.pinned:
            s = p.state
            sc = sps[s]
            if not sps_h[j, s] > GATE:
                continue
            eop = int(ipm[p.eop_lane])
            lvv = hv[W_PAD + max(eop, -W_PAD), p.lane]
            vnew[s] = torch.where(lvv > GATE, lvv + sc, NEGt)

        # exon convolutions: per variant a logsumexp over its band, then
        # one into the conv's value
        for cv in st.convs:
            gp = int(ipc[cv.ip_lane])
            if not gp & 1:
                continue
            phi = gp >> 1
            smin, smax = int(ipc[cv.ip_lane + 1]), int(ipc[cv.ip_lane + 2])
            quot = None
            if cv.hint is not None:
                quot = conv_quot(cv, j, lm, xh_all[j], xi_h[j], hw)
            best = NEGt
            for var in cv.variants:
                score, _ = band_score(cv, var, j, phi, smin, smax, hv, gc,
                                      lv, lv_h, sph, quot)
                sbest, k = _lse(score)
                best, k2 = _lse2(best, variant_best(var, sbest, sph))
                sfu += k + k2
            vnew[cv.state] = best

        rows[j] = vnew
        v = vnew
        sfu += lane_update(j, v)
    return rows, int(sfu)


def forward_work(static: PKStatic, planes: Dict[str, torch.Tensor]):
    """What one launch must move, for the roofline bound: kernel_work's
    bytes (the same plane reads) with the forward's own outputs (the f rows,
    (n, 64) float32) and scratch (the lane values, no args)."""
    parts, _ = kernel_work(static, planes)
    parts["outputs"] = static.n * 64 * 4
    parts["scratch"] = static.n * static.NL * 4
    return parts


# --------------------------------------------------------------------------
# the wrapper: kernel on CUDA tensors, plain version on CPU tensors
# --------------------------------------------------------------------------

# csrc/forward.cu: warps of the block (the last two take the thread items)
# and the widest lessD window (two entries per lane of a warp)
K3_WARPS = 16
LESSD_MAXW = 64


def _window_refusal(static: PKStatic) -> Optional[str]:
    wide = [d.window for d in static.lessd if d.window > LESSD_MAXW]
    if wide:
        return (f"a lessD window of {max(wide)} positions (the forward "
                f"kernel takes {LESSD_MAXW})")
    return None


def kernel_limits(static: PKStatic) -> None:
    """Raise NotImplementedError for a piece beyond what csrc/forward.cu
    takes on top of the Viterbi kernel's limits (variants per conv, hint
    slots, shared memory and descriptor size, which _descriptor and
    smem_layout check): a lessD window wider than LESSD_MAXW.  A conv's
    band has no limit: entries past the K3_R kept per lane are rebuilt."""
    msg = _window_refusal(static)
    if msg:
        raise NotImplementedError(msg)


def k3_fits(static: PKStatic, arrays) -> bool:
    """Whether K3 holds the chunk of pack_tracks' (static, arrays): K1's
    checks (viterbi.k1_refusal, which K3's wrapper makes through _check)
    and the lessD window of kernel_limits; decided before any launch."""
    from .viterbi import k1_refusal, packed_widths
    return k1_refusal(static, *packed_widths(arrays)) is None and \
        _window_refusal(static) is None


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]


def forward_table(static: PKStatic, planes: Dict[str, torch.Tensor],
                  defines=()) -> torch.Tensor:
    """The forward rows (n, 64) float32 of one chunk (row 0 = v0; planes
    from pack.forward_arrays).  CPU tensors run the plain version; CUDA
    tensors launch csrc/forward.cu (and raise if it does not build or
    launch), built with the preprocessor `defines` of a measurement variant
    when they are given.  `forward_table.launches` counts kernel
    launches."""
    dev = _check(static, planes)
    if dev.type == "cpu":
        return forward_reference(static, planes)[0]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    kernel_limits(static)
    from ._build import load
    fn = load("forward", defines).forward_table_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = static.n
    nxh, nxi = _hint_widths(static, planes)
    desc_h = _descriptor(static, planes["sel_pack"].cpu().numpy(), nxh, nxi)
    smem = smem_layout(static, desc_h.shape[0], nxh, nxi)["bytes"]
    desc = torch.from_numpy(desc_h).to(dev)
    p = planes
    ltcT = p["ltc_all"].transpose(1, 2).contiguous()     # [c][s][p]
    lane_tr = p["lt_T"].t().contiguous()                 # [l][p]
    hs = W_PAD + n
    hist_v = torch.empty((64, hs), dtype=torch.float32, device=dev)
    rows = torch.empty((n, 64), dtype=torch.float32, device=dev)
    hinted = bool(static.NHW)
    err = fn(p["sp_state"].data_ptr(), p["sp_geo"].data_ptr(),
             p["sp_convH"].data_ptr(), p["ip_conv"].data_ptr(),
             p["ip_misc"].data_ptr(), p["gcum"].data_ptr(),
             p["msk"].data_ptr(), ltcT.data_ptr(), lane_tr.data_ptr(),
             p["lv_pack"].data_ptr(), p["v0"].data_ptr(), p["l0"].data_ptr(),
             int(desc.shape[0]), desc.data_ptr(), hist_v.data_ptr(),
             rows.data_ptr(), n, static.NGR, static.NMS, static.NHW,
             p["gcum"].shape[-1], hs,
             p["xh_plane"].data_ptr() if hinted else None,
             p["xi_plane"].data_ptr() if hinted else None,
             p["hw_rows"].data_ptr() if hinted else None, nxh, nxi, smem,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"forward_table kernel launch failed: CUDA error "
                           f"{err}")
    forward_table.launches += 1
    return rows


forward_table.launches = 0


class ForwardEngine:
    """The forward table of one chunk in true log space, for the sampling
    walk (GoldEngine.sample_path): the counterpart of augustus_tpu's
    scan.ForwardEngine.  `packed`: pack_tracks' result when the caller
    packed already (the Viterbi engine of the same chunk), so that one
    packing serves both passes.  The heat (8 - t) / 8 of --temperature=t
    comes from the chunk's constants."""

    def __init__(self, tracks: DPTracks, device, packed=None):
        self.tracks = tracks
        self.device = torch.device(device)
        self.static, arrays = packed if packed is not None \
            else pack_tracks(tracks)
        self.heat = (8.0 - tracks.gold.cn.temperature) / 8.0
        self.arrays = forward_arrays(self.static, arrays, self.heat)

    def rows(self) -> torch.Tensor:
        """The kernel's rows (n, 64) float32, rebased, on the device."""
        from .. import stats
        with stats.stage("forward", self.device):
            return forward_table(self.static, planes_for(
                self.static, self.arrays, self.device))

    def run(self) -> np.ndarray:
        """The (n, S) float64 table: rows + tracks.base * heat, -inf where
        a row is at or below F32_NEG / 2 (augustus_tpu scan.py:977-991)."""
        n, S = self.static.n, self.static.S
        f = self.rows()[:n, :S].cpu().numpy().astype(np.float64)
        base = np.asarray(self.tracks.base) * self.heat
        return np.where(f > float(F32_NEG) / 2, f + base[:n, None], -np.inf)
