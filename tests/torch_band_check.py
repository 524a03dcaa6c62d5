"""The exon convolutions' band clipping of csrc/viterbi.cu, checked on data
with the plain version's own band score (engine/viterbi.py:band_score).

The kernel walks only the begins b in [smin, smax] of each variant.  That
is exact if, at every gated position of every conv and variant, the full
band scores NEG outside [smin, smax] and, whenever the variant's value
exceeds GATE, the clipped slice gives the same (value, pred, off)."""

import numpy as np
import torch

from augustus_tpu_torch.engine.pack import W_PAD
from augustus_tpu_torch.engine.viterbi import (
    GATE, NEG, _hint_lm32, _last_argmax, band_score, conv_quot, variant_best)


def lane_history(st, planes, vals):
    """The lane history (values, first-argmax args), position-major with
    W_PAD rows of l0/a0 in front, from the plain version's per-step values:
    the arithmetic of its lane update."""
    S, NL = st.S, st.NL
    ltr = planes["lt_T"][:S, :NL].t()
    cand = vals[:, None, :S] + ltr[None]                    # (n, NL, S)
    m = cand.max(dim=2).values
    arg = torch.argmax((cand == m[..., None]).to(torch.int8), dim=2)
    hv = torch.cat([planes["l0"].reshape(-1)[:NL].expand(W_PAD, NL), m])
    ha = torch.cat([planes["a0"].reshape(-1)[:NL].long().expand(W_PAD, NL),
                    arg])
    return hv, ha


def check_band_clipping(st, planes, vals) -> int:
    """Assert the clipping invariants at every gated conv position and
    variant of the chunk; return how many (position, conv, variant) had a
    value above GATE, where the clipped slice had to agree."""
    vals = torch.as_tensor(vals)
    hv, ha = lane_history(st, planes, vals)
    ipc = planes["ip_conv"].numpy()
    ipm = planes["ip_misc"].numpy()
    lv = planes["lv_pack"].reshape(-1)
    lv_h = lv.numpy()
    quot_args = None
    if st.NHW:
        quot_args = (torch.from_numpy(_hint_lm32(st)).unbind(),
                     planes["xh_plane"], planes["xi_plane"].numpy(),
                     planes["hw_rows"])
    live = 0
    for j in range(1, st.n):
        gc = planes["gcum"][int(ipm[j, st.cls_lane])]
        sph = planes["sp_convH"][j]
        for cv in st.convs:
            gp = int(ipc[j, cv.ip_lane])
            if not gp & 1:
                continue
            smin, smax = int(ipc[j, cv.ip_lane + 1]), int(ipc[j, cv.ip_lane + 2])
            quot = None
            if cv.hint is not None:
                lm, xh, xi, hw = quot_args
                quot = conv_quot(cv, j, lm, xh[j], xi[j], hw)
            for var in cv.variants:
                score, fl = band_score(cv, var, j, gp >> 1, smin, smax, hv,
                                       gc, lv, lv_h, sph, quot)
                b0 = j + cv.a_off - var.len_hi
                b = b0 + np.arange(var.width)
                outside = torch.from_numpy((b < smin) | (b > smax))
                assert (score[outside] == float(NEG)).all(), (j, cv.state)
                sbest, ridx = _last_argmax(score)
                vbest = variant_best(var, sbest, sph)
                lo, hi = max(0, smin - b0), min(var.width - 1, smax - b0)
                if lo > hi:
                    assert not bool(vbest > GATE), (j, cv.state)
                    continue
                cbest, cidx = _last_argmax(score[lo: hi + 1])
                cidx += lo
                cval = variant_best(var, cbest, sph)
                if not bool(vbest > GATE):
                    continue
                live += 1
                r0 = b0 - cv.bpl - 1

                def pred_off(i):
                    return (int(ha[W_PAD + r0 + i, cv.lane + int(fl[i])]),
                            (var.len_hi - cv.a_off + cv.bpl + 1) - i)
                assert torch.equal(cval.view(torch.int32),
                                   vbest.view(torch.int32)), (j, cv.state)
                assert pred_off(cidx) == pred_off(ridx), (j, cv.state)
    return live
