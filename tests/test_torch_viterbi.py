"""The plain PyTorch version of the Viterbi kernel against the reference
XLA scan (make_scan_fn, debug_vals=True) on the CPU: per-step values,
live backpointers and the final column bit-equal (tolerance 0: both are
max-plus in float32 with the same operand order)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from augustus_tpu import genetics as jgenetics
from augustus_tpu.engine import pallas_pack as jpack
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.engine.scan import make_scan_fn, split_tracks
from augustus_tpu.io.fasta import read_fasta
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.convert import pack_from_reference
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.engine.pack import pack_tracks
from augustus_tpu_torch.engine.viterbi import (
    ViterbiEngine, planes_for, viterbi_forward, viterbi_forward_reference)
from augustus_tpu_torch.predict import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
SEQ = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0] \
    .sequence.lower()

# (species, chunk length): 2.5 kb; 6 kb crosses BLK=2048 and W_PAD=3200;
# the gc2 chunk holds a GC-class switch
CASES = [("repo_fixture", 2500), ("repo_fixture", 6000),
         ("repo_fixture_gc2", 6000)]


def _args(species):
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}


def _reference_tracks(species, n):
    jm = JModel.load(_args(species))
    codes = jgenetics.encode(SEQ[:n])
    eng = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode)
    eng.prepare(codes)
    return jbuild(eng), eng


def _scan(tr):
    st, arr = split_tracks(tr)
    fn = jax.jit(make_scan_fn(st, debug_vals=True))
    vfin, (bps, vals) = fn(jax.tree_util.tree_map(jnp.asarray, arr),
                           jnp.asarray(tr.log_init))
    return np.asarray(vfin), np.asarray(bps), np.asarray(vals)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    species, n = request.param
    jtr, jeng = _reference_tracks(species, n)
    m = Model.load(_args(species))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[:n]))
    st, arr = pack_tracks(build_tracks(eng))
    bp, vfin, vals = viterbi_forward(st, planes_for(st, arr, "cpu"),
                                     debug_vals=True)
    return {"species": species, "jtr": jtr, "jeng": jeng, "st": st,
            "arr": arr, "bp": bp.numpy(), "vfin": vfin.numpy(),
            "vals": vals.numpy(), "scan": _scan(jtr)}


def test_values_equal(case):
    _, _, sv = case["scan"]
    st = case["st"]
    pv = case["vals"][1: st.n, : st.S]
    assert sv.shape == pv.shape
    assert np.array_equal(sv.view(np.int32), pv.view(np.int32))


def test_live_backpointers_equal(case):
    _, sb, sv = case["scan"]
    st = case["st"]
    live = sv > -5.0e29
    assert live.sum() > 1000
    pb = case["bp"][1: st.n, : st.S]
    assert ((sb == pb) | ~live).all()


def test_final_column_equal(case):
    sf, _, _ = case["scan"]
    assert np.array_equal(sf, case["vfin"][: case["st"].S])


def test_band_clipping_is_exact(case):
    """At every gated conv position and variant, the plain version's full
    band is NEG outside [smin, smax], and wherever the variant's value
    exceeds GATE its clipped slice (what the kernel walks) gives the same
    value, pred and off."""
    from torch_band_check import check_band_clipping
    st = case["st"]
    assert check_band_clipping(st, planes_for(st, case["arr"], "cpu"),
                               case["vals"]) > 100


def test_class_switch_exercised(case):
    switches = int((np.diff(case["jeng"].stairs) != 0).sum())
    assert (switches >= 1) == case["species"].endswith("gc2")


def test_same_decode_from_reference_packing():
    """convert.pack_from_reference: the reference package's packing fed
    straight to the port's plain version decodes what the port's own
    preparation decodes."""
    species, n = "repo_fixture_gc2", 1500
    jtr, _ = _reference_tracks(species, n)
    jst, jarr = jpack.pack_tracks(jtr)
    st, arr = pack_from_reference(dataclasses.asdict(jst), jarr)
    bp, vfin, _ = viterbi_forward_reference(st, planes_for(st, arr, "cpu"))
    m = Model.load(_args(species))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[:n]))
    st2, arr2 = pack_tracks(build_tracks(eng))
    assert st2 == st
    bp2, vfin2, _ = viterbi_forward(st2, planes_for(st2, arr2, "cpu"))
    assert np.array_equal(bp.numpy(), bp2.numpy())
    assert np.array_equal(vfin.numpy(), vfin2.numpy())


def test_engine_traceback_matches_reference(case):
    """ViterbiEngine's walk on the port's plane gives the reference's raw
    segments (the reference walks its own scan plane, bps[j-1] layout)."""
    from augustus_tpu.engine import traceback as jtb
    sf, sb, _ = case["scan"]
    jtr, st = case["jtr"], case["st"]
    state0 = int(np.argmax(sf + np.asarray(jtr.log_term)))
    packed, fb = jtb.make_trace_fn(st.n, -1)(jnp.asarray(sb), state0)
    ref = [(b, e, int(t)) for b, e, t in jtb.raw_segments(
        np.asarray(packed), int(fb), jtr.gold.sg.state_types)]
    m = Model.load(_args(case["species"]))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[: st.n]))
    ve = ViterbiEngine(build_tracks(eng), "cpu")
    ve.bp = torch.from_numpy(case["bp"])
    ve.v_final = np.full(ve.tracks.S, np.float32(-1e30), np.float32)
    ve.v_final[: ve.S] = case["vfin"][: ve.S]
    got = [(b, e, int(t)) for b, e, t in ve.traceback()]
    assert got == ref
    assert len(got) > 10


def _reads_of_the_kernel(st, planes):
    """Every element that csrc/viterbi.cu's phases read, marked position by
    position as its code reads it (an exon convolution's variant only at
    the begins in [smin, smax]): {plane: bool mask}."""
    from augustus_tpu_torch.engine.pack import W_PAD
    from augustus_tpu_torch.engine.viterbi import (
        GATE, HINT_W_ROWS, HINT_X_LANES, _W_AT_BOB_M1, _fixed_lanes)
    h = {k: v.numpy() for k, v in planes.items()}
    ipm, ipc, sps, msk = h["ip_misc"], h["ip_conv"], h["sp_state"], h["msk"]
    seen = {k: np.zeros(v.shape, dtype=bool) for k, v in h.items()}
    fixed = _fixed_lanes(st, h["sel_pack"])
    for j in range(1, st.n):
        c = ipm[j, st.cls_lane]
        seen["ip_misc"][j, st.cls_lane] = True
        seen["sp_state"][j, list(st.chain_states)] = True
        for (s, _, _, kind, _, gbit) in fixed:
            seen["ip_misc"][j, st.gate_lane] = True
            if (ipm[j, st.gate_lane] >> gbit) & 1:
                seen["sp_state"][j, s] = True
                seen["sp_geo"][j, s] |= kind in (1, 2)
        for p in st.pinned:
            seen["sp_state"][j, p.state] = True
            if sps[j, p.state] > GATE:
                seen["ip_misc"][j, p.eop_lane] = True
        for d in st.lessd:
            seen["sp_state"][j, d.state] = True
            if not sps[j, d.state] > GATE:
                continue
            seen["ip_misc"][j, d.jsel_lane] = True
            r = j - d.window + np.arange(d.window)
            seen["gcum"][c, d.cum_row, W_PAD + np.append(r, j)] = True
            r = r[r >= 0]
            seen["msk"][d.valid_row, W_PAD + r] = True
            r = r[msk[d.valid_row, W_PAD + r] != 0]
            seen["msk"][d.stop_row, W_PAD + r] = True
        for cv in st.convs:
            seen["ip_conv"][j, cv.ip_lane] = True
            gp = ipc[j, cv.ip_lane]
            if not gp & 1:
                continue
            seen["ip_conv"][j, cv.ip_lane + 1: cv.ip_lane + 3] = True
            phi = gp >> 1
            smin, smax = ipc[j, cv.ip_lane + 1], ipc[j, cv.ip_lane + 2]
            clipped = {}
            for v in cv.variants:
                # only the begins b in [smin, smax]
                b0 = j + cv.a_off - v.len_hi
                w = np.arange(max(smin - b0, 0), min(smax - b0, v.width - 1)
                              + 1)
                clipped[v] = w
                col = W_PAD + b0 + w
                two = (w >= v.g2_from) if v.g2row >= 0 else w < 0
                seen["gcum"][c, v.g3row + phi, col[~two]] = True
                seen["gcum"][c, v.g2row + phi, col[two]] = True
                if v.hv_base >= 0:
                    seen["sp_convH"][j, v.hv_base + w] = True
                else:
                    seen["sp_convH"][j, v.h_lane] = True
            hr = cv.hint
            if hr is None:
                continue
            for k in HINT_X_LANES:
                if hr.aR or k not in ("x_c2_ep", "x_cntc2_ep"):
                    seen["xh_plane"][j, getattr(hr, k)] = True
            for (il, wl, fl) in hr.cross + hr.ex:
                seen["xh_plane"][j, wl] = True
                seen["xi_plane"][j, [il, fl]] = True
            for v in cv.variants:
                bob = j + cv.a_off - v.len_hi + clipped[v] - hr.ipo
                for k in HINT_W_ROWS:
                    off = -1 if k in _W_AT_BOB_M1 else 0
                    seen["hw_rows"][getattr(hr, k), W_PAD + bob + off] = True
    return seen


def test_kernel_work_counts_each_read_once(case):
    """kernel_work's bytes equal the elements the kernel's code reads,
    marked position by position; outputs and the lane history are written
    once."""
    from augustus_tpu_torch.engine.viterbi import kernel_work
    st = case["st"]
    planes = planes_for(st, case["arr"], "cpu")
    parts, ops = kernel_work(st, planes)
    seen = _reads_of_the_kernel(st, planes)
    for k in ("sp_state", "sp_geo", "sp_convH", "ip_conv", "ip_misc",
              "gcum", "msk"):
        assert parts[k] == int(seen[k].sum()) * 4, k
    assert parts["outputs"] == (st.n * 64 + 64) * 4
    assert parts["scratch"] == st.n * st.NL * 8
    whole = sum(planes[k].numel() * 4 for k in seen if k != "sel_pack")
    assert 0 < sum(parts.values()) < whole
    assert ops["dp"] > st.n * st.NL * st.S * 2
    assert ops["hint_quot"] == 0


def _quot_ops_of_the_kernel(st, planes):
    """The hint quotient's float operations that the chunk's data needs,
    replayed position by position over the kernel's band entries: each
    unmasked begin once per position and conv, with the slot terms that
    apply to it."""
    from augustus_tpu_torch.engine.viterbi import QUOT_OPS, QUOT_SIDE_OPS
    ipc = planes["ip_conv"].numpy().astype(np.int64)
    xi = planes["xi_plane"].numpy().astype(np.int64)
    ops = 0
    for j in range(1, st.n):
        for cv in st.convs:
            h = cv.hint
            if h is None or not ipc[j, cv.ip_lane] & 1:
                continue
            smin, smax = ipc[j, cv.ip_lane + 1], ipc[j, cv.ip_lane + 2]
            b = np.unique(np.concatenate([
                j + cv.a_off - v.len_hi + np.arange(v.width)
                for v in cv.variants]))
            bob = b[(b >= smin) & (b <= smax)] - h.ipo
            ops += bob.size * (QUOT_OPS + QUOT_SIDE_OPS * (h.aL + h.aR))
            for (sl, _, fl) in h.cross:
                if xi[j, fl] in (1, 2):
                    ops += 2 * int((bob <= xi[j, sl]).sum())
                if h.exclass == 2 and xi[j, fl] == 4:
                    ops += int((bob == xi[j, sl]).sum())
            for (pl, _, kl) in h.ex:
                pk, kd = xi[j, pl], xi[j, kl]
                if kd == 1 or (h.exclass == 1 and kd == 2):
                    ops += int((bob == pk).sum())
                if h.exclass == 3 and kd == 3 and pk > -(1 << 29):
                    ops += int((bob > pk).sum())
    return ops


def test_kernel_work_counts_hint_reads():
    """On the 6 kb hinted chunk (softmasked HS04636sm.fa with its EST
    hints): hint_x and hint_w equal the xh/xi lanes and window columns the
    kernel's code reads, marked position by position, as do the other
    parts; the quotient's operations equal a position-by-position replay
    of the unmasked band entries and the slot terms that apply."""
    from augustus_tpu_torch.engine.viterbi import kernel_work
    from augustus_tpu_torch.predict import piece_planes
    hints = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints",
                         "HS04636sm.E.gff")
    m = Model.load(dict(_args("repo_fixture"), softmasking="1",
                        hintsfile=hints,
                        extrinsicCfgFile="extrinsic.M.RM.E.W.cfg"))
    rec = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636sm.fa"))[0]
    st, planes, _ = piece_planes(m, rec, 6000, "cpu")
    assert st.NHW > 0
    parts, ops = kernel_work(st, planes)
    assert 0 < ops["hint_quot"] == _quot_ops_of_the_kernel(st, planes)
    seen = _reads_of_the_kernel(st, planes)
    for k in ("sp_state", "sp_geo", "sp_convH", "ip_conv", "ip_misc",
              "gcum", "msk"):
        assert parts[k] == int(seen[k].sum()) * 4, k
    assert parts["hint_w"] == int(seen["hw_rows"].sum()) * 4
    assert parts["hint_x"] == int(seen["xh_plane"].sum()
                                  + seen["xi_plane"].sum()) * 4
    assert 0 < parts["hint_x"] < parts["hint_w"]


def test_wrapper_checks_its_inputs():
    species, n = "repo_fixture", 300
    m = Model.load(_args(species))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[:n]))
    st, arr = pack_tracks(build_tracks(eng))
    planes = planes_for(st, arr, "cpu")
    bad = dict(planes, sp_state=planes["sp_state"].double())
    with pytest.raises(ValueError, match="dtype"):
        viterbi_forward(st, bad)
    bad = dict(planes, gcum=planes["gcum"][:, :, :-1])
    with pytest.raises(ValueError, match="gcum"):
        viterbi_forward(st, bad)
    with pytest.raises(ValueError, match="sparse hints"):
        viterbi_forward(_with_nhw(st), planes)
    before = viterbi_forward.launches
    viterbi_forward(st, planes)
    assert viterbi_forward.launches == before    # CPU: no kernel launch


def _with_nhw(st):
    """The static of a chunk with sparse exon/CDS hint rows."""
    class Hinted:
        def __getattr__(self, k):
            return 8 if k == "NHW" else getattr(st, k)
    return Hinted()


@pytest.mark.slow
def test_against_pallas_interpret():
    """The TPU kernel itself, in interpret mode, on the 2.5 kb chunk."""
    from augustus_tpu.engine.pallas_scan import PallasEngine
    jtr, jeng = _reference_tracks("repo_fixture", 2500)
    pe = PallasEngine(jtr, interpret=True)
    pe.run()
    m = Model.load(_args("repo_fixture"))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[:2500]))
    st, arr = pack_tracks(build_tracks(eng))
    bp, vfin, vals = viterbi_forward(st, planes_for(st, arr, "cpu"), True)
    n, S = st.n, st.S
    pv = pe.v_debug[1:n, :S]
    assert np.array_equal(pv, vals.numpy()[1:n, :S])
    live = pv > -5.0e29
    assert ((pe.backptr[1:n, :S] == bp.numpy()[1:n, :S]) | ~live).all()
    assert np.array_equal(pe.v_final[:S], vfin.numpy()[:S])


def test_kernel_sizing_on_the_fixtures():
    """The wrapper's sizing of the kernel on the fixture statics: the
    shared-memory layout's regions follow each other inside the block's
    232,448 bytes, the lessD length vectors take rows of the widest window
    (59), and the descriptor's header tells the kernel the same layout."""
    from augustus_tpu_torch.engine.viterbi import (
        SMEM_LIMIT, STAGES, _descriptor, _LAYOUT_FIELDS, smem_layout)
    for species in ("repo_fixture", "repo_fixture_gc2"):
        m = Model.load(_args(species))
        eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
        eng.prepare(jgenetics.encode(SEQ[:300]))
        st, arr = pack_tracks(build_tracks(eng))
        desc = _descriptor(st, arr["sel_pack"])
        lay = smem_layout(st, len(desc))
        assert lay["lvw"] == 59
        order = ["lt", "ltc", "lvl", "f0", "vbuf", "kind", "stage", "warp",
                 "lpi", "lpc", "chi", "chc"]
        starts = [lay[k] for k in order]
        assert starts == sorted(starts) and starts[0] >= len(desc)
        assert lay["lvl"] + len(st.lessd) * 59 <= lay["f0"]
        assert lay["stage"] + STAGES * lay["st_w"] <= lay["warp"]
        assert 0 < lay["bytes"] <= SMEM_LIMIT
        head = desc[16: 17 + len(_LAYOUT_FIELDS)].tolist()
        assert head == [st.C] + [lay[k] for k in _LAYOUT_FIELDS]


@pytest.mark.parametrize("what", ["variants", "shared_memory"])
def test_beyond_the_kernel_raises_before_launch(what):
    """A chunk beyond what the kernel holds (a conv of more than MAX_VAR
    variants; tables beyond the block's shared memory) is refused with
    NotImplementedError before any launch, never truncated."""
    from augustus_tpu_torch.engine.viterbi import MAX_VAR
    m = Model.load(_args("repo_fixture"))
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(SEQ[:300]))
    st, arr = pack_tracks(build_tracks(eng))
    planes = planes_for(st, arr, "cpu")
    if what == "variants":
        cv = st.convs[-1]
        wide = dataclasses.replace(cv, variants=cv.variants * (
            MAX_VAR // len(cv.variants) + 1))
        big, match = dataclasses.replace(
            st, convs=st.convs[:-1] + (wide,)), "variants"
    else:
        # the lessD length vectors of a 60,000-position window do not fit
        d = st.lessd[0]
        big, match = dataclasses.replace(st, lessd=(dataclasses.replace(
            d, window=60_000),) + st.lessd[1:]), "shared memory"
    before = viterbi_forward.launches
    with pytest.raises(NotImplementedError, match=match):
        viterbi_forward(big, planes)
    assert viterbi_forward.launches == before
