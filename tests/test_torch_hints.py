"""Softmasked, EST-hinted chunks on the CPU: the port's host preparation
and packing against augustus_tpu's (statics equal, integer tables exact,
float tables bit-equal), the port's plain Viterbi version against the
reference XLA scan (make_scan_fn, debug_vals=True; per-step values, live
backpointers and the final column bit-equal, tolerance 0), and the hint
fixture: deterministic, and reaching every branch of the quotient K1.f."""

import copy
import dataclasses
import importlib.util
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
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch import genetics
from augustus_tpu_torch.convert import pack_from_reference
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.engine.pack import (W_PAD, expand_arrays,
                                            pack_tracks, to_device)
from augustus_tpu_torch.engine.viterbi import planes_for, viterbi_forward
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.io.tiled import tiled_hinted
from augustus_tpu_torch.model.state_config import is_on_f_strand
from augustus_tpu_torch.predict import Model, _piece_hints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
PKG_DATA = os.path.join(ROOT, "augustus_tpu_torch", "data")
CONFIG = os.path.join(PKG_DATA, "config")
HINTS = os.path.join(PKG_DATA, "hints")
DATA = os.path.join(ROOT, "tests", "data")
FILES = {"sm": ("HS04636sm.fa", "HS04636sm.E.gff"),
         "rc": ("HS04636rc.fa", "HS04636rc.E.gff")}


def _args(species, which):
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "1",
            "hintsfile": os.path.join(HINTS, FILES[which][1]),
            "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}


def _chunk(which, n):
    rec = read_fasta(os.path.join(DATA, FILES[which][0]))[0]
    return rec.name, rec.sequence[:n]


def _engines(species, which, n):
    """(reference engine, port engine), prepared like a prediction of the
    first n bases: softmask and the hints that end inside the chunk."""
    name, seq = _chunk(which, n)
    jm = JModel.load(_args(species, which))
    je = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
               ext_cfg=jm.ext_cfg)
    je.prepare(jgenetics.encode(seq.lower()),
               softmask=jgenetics.softmask_runs(seq),
               gff_hints=[copy.copy(f) for f in jm.gff_hints[name]
                          if f.end < len(seq)])
    return je, _port_engine(species, which, n)[0]


def _port_engine(species, which, n):
    """The port's engine prepared like _engines', and its model."""
    name, seq = _chunk(which, n)
    m = Model.load(_args(species, which))
    e = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode,
                   ext_cfg=m.ext_cfg)
    e.prepare(genetics.encode(seq.lower()),
              softmask=genetics.softmask_runs(seq),
              gff_hints=_piece_hints(m.gff_hints[name], 0, len(seq) - 1))
    return e, m


def _port_pack(species, which, n):
    e, m = _port_engine(species, which, n)
    st, arr = pack_tracks(build_tracks(e))
    return st, arr, m


# ---------------------------------------------------------------------------
# host preparation and packing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prepared():
    je, e = _engines("repo_fixture", "sm", 6000)
    jtr, tr = jbuild(je), build_tracks(e)
    return jtr, tr, jpack.pack_tracks(jtr), pack_tracks(tr)


def test_hint_tables_equal(prepared):
    jtr, tr, _, _ = prepared
    assert tr.hint_lm == jtr.hint_lm and len(tr.hint_lm) == 5
    assert set(tr.hint_tables) == set(jtr.hint_tables) == {"+", "-"}
    for strand, jt in jtr.hint_tables.items():
        t = tr.hint_tables[strand]
        for rows in ("wrows", "xrows"):
            a, b = getattr(jt, rows), getattr(t, rows)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, (strand, rows, k)
                assert np.array_equal(a[k], b[k]), (strand, rows, k)
        for k in ("cross_start", "cross_w", "cross_flag", "ex_pos", "ex_w",
                  "ex_kind"):
            assert np.array_equal(getattr(jt, k), getattr(t, k)), k


def test_static_and_arrays_equal(prepared):
    _, _, (jst, jarr), (st, arr) = prepared
    assert st.NHW > 0 and st.hint_lm is not None
    assert dataclasses.asdict(jst) == dataclasses.asdict(st)
    for k, v in arr.items():
        ref = np.asarray(jarr[k])
        if k in ("m_xh", "m_xi"):
            # the reference's maps are 128 lanes wide; the port's hold the
            # lanes in use, in the same order
            assert np.array_equal(ref[: len(v)], v) and (ref[len(v):] == -1
                                                         ).all(), k
            continue
        assert v.shape == ref.shape and v.dtype == ref.dtype, k
        assert np.array_equal(v.view(np.uint8), ref.view(np.uint8)), k


def test_expand_arrays_equal(prepared):
    _, _, (jst, jarr), (st, arr) = prepared
    ref = jpack.expand_arrays(jst, {k: jnp.asarray(v) for k, v in
                                    jarr.items()})
    got = expand_arrays(st, to_device(arr, "cpu"))
    for k, rk in (("sp_state", "sp_state"), ("ip_conv", "ip_conv"),
                  ("gcum", "gcum_hbm"), ("msk", "msk_hbm"),
                  ("hw_rows", "hw_hbm")):
        r, g = np.asarray(ref[rk]), got[k].numpy()
        assert g.shape == r.shape and np.array_equal(
            g.view(np.int32), r.view(np.int32)), k
    for k, fill in (("xh_plane", 0), ("xi_plane", -(1 << 30))):
        r, g = np.asarray(ref[k]), got[k].numpy()
        w = g.shape[1]
        assert g.shape[0] == r.shape[0] and w < r.shape[1]
        assert np.array_equal(g.view(np.int32), r[:, :w].view(np.int32)), k
        assert (r[:, w:] == fill).all(), k


def test_same_decode_from_reference_packing(prepared):
    """convert.pack_from_reference carries NHW, hint_lm and each conv's
    hint across: the reference's hinted packing decodes as the port's."""
    _, _, (jst, jarr), (st, arr) = prepared
    st2, arr2 = pack_from_reference(dataclasses.asdict(jst), jarr)
    assert st2 == st
    for k in ("m_xh", "m_xi", "hw_src"):
        assert np.array_equal(arr2[k], arr[k]), k
    bp, vfin, _ = viterbi_forward(st, planes_for(st, arr, "cpu"))
    bp2, vfin2, _ = viterbi_forward(st2, planes_for(st2, arr2, "cpu"))
    assert torch.equal(bp, bp2) and torch.equal(vfin, vfin2)


# ---------------------------------------------------------------------------
# the plain Viterbi version against the reference scan
# ---------------------------------------------------------------------------

# (species, input, length): both strands' hints, 2.5 and 6 kb (crossing
# BLK=2048 and W_PAD=3200), and the gc2 class switch across hinted bands
CASES = [("repo_fixture", "sm", 2500), ("repo_fixture", "sm", 6000),
         ("repo_fixture", "rc", 6000), ("repo_fixture_gc2", "sm", 6000)]


def _scan(tr):
    st, arr = split_tracks(tr)
    fn = jax.jit(make_scan_fn(st, debug_vals=True))
    vfin, (bps, vals) = fn(jax.tree_util.tree_map(jnp.asarray, arr),
                           jnp.asarray(tr.log_init))
    return np.asarray(vfin), np.asarray(bps), np.asarray(vals)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def case(request):
    species, which, n = request.param
    je, e = _engines(species, which, n)
    st, arr = pack_tracks(build_tracks(e))
    planes = planes_for(st, arr, "cpu")
    bp, vfin, vals = viterbi_forward(st, planes, debug_vals=True)
    return {"species": species, "jeng": je, "st": st, "planes": planes,
            "bp": bp.numpy(),
            "vfin": vfin.numpy(), "vals": vals.numpy(),
            "scan": _scan(jbuild(je))}


def test_hinted_values_equal(case):
    _, _, sv = case["scan"]
    st = case["st"]
    assert st.NHW > 0
    pv = case["vals"][1: st.n, : st.S]
    assert sv.shape == pv.shape
    assert np.array_equal(sv.view(np.int32), pv.view(np.int32))


def test_hinted_live_backpointers_equal(case):
    _, sb, sv = case["scan"]
    st = case["st"]
    live = sv > -5.0e29
    assert live.sum() > 1000
    assert ((sb == case["bp"][1: st.n, : st.S]) | ~live).all()


def test_hinted_final_column_equal(case):
    sf, _, _ = case["scan"]
    assert np.array_equal(sf, case["vfin"][: case["st"].S])
    switches = int((np.diff(case["jeng"].stairs) != 0).sum())
    assert (switches >= 1) == case["species"].endswith("gc2")


def test_hinted_band_clipping_is_exact(case):
    """The band clipping on the hinted chunks (both strands, gc2): the
    full band, quotient included, is NEG outside [smin, smax], and the
    clipped slice gives the same value, pred and off wherever the
    variant's value exceeds GATE."""
    from torch_band_check import check_band_clipping
    st = case["st"]
    assert check_band_clipping(st, case["planes"], case["vals"]) > 100


def test_hinted_against_pallas_interpret():
    """The TPU kernel itself, K1.f included, in interpret mode on the
    2.5 kb hinted chunk, against the port's plain version."""
    from augustus_tpu.engine.pallas_scan import PallasEngine
    je, e = _engines("repo_fixture", "sm", 2500)
    pe = PallasEngine(jbuild(je), interpret=True)
    pe.run()
    st, arr = pack_tracks(build_tracks(e))
    assert st.NHW > 0
    bp, vfin, vals = viterbi_forward(st, planes_for(st, arr, "cpu"), True)
    n, S = st.n, st.S
    pv = pe.v_debug[1:n, :S]
    assert np.array_equal(pv.view(np.int32), vals.numpy()[1:n, :S].view(
        np.int32))
    live = pv > -5.0e29
    assert ((pe.backptr[1:n, :S] == bp.numpy()[1:n, :S]) | ~live).all()
    assert np.array_equal(pe.v_final[:S], vfin.numpy()[:S])


# ---------------------------------------------------------------------------
# the fixture reaches every branch of the quotient, and is deterministic
# ---------------------------------------------------------------------------

def _branches(st, planes, state_types):
    """The branches of hint_quot that the chunk reaches at a gated position
    of a hinted conv, inside the band's start bounds."""
    xh, xi = planes["xh_plane"].numpy(), planes["xi_plane"].numpy()
    hw, ipc = planes["hw_rows"].numpy(), planes["ip_conv"].numpy()
    hits = {"NHW>0"} if st.NHW else set()
    for cv in st.convs:
        h = cv.hint
        if h is None:
            continue
        hits.add(f"exclass{h.exclass}")
        strand = "+" if is_on_f_strand(state_types[cv.state]) else "-"
        for j in np.flatnonzero(ipc[1: st.n, cv.ip_lane] & 1) + 1:
            lo = max(min(j + cv.a_off - v.len_hi for v in cv.variants),
                     ipc[j, cv.ip_lane + 1])
            hi = min(max(j + cv.a_off - v.len_lo for v in cv.variants),
                     ipc[j, cv.ip_lane + 2])
            if lo > hi:
                continue
            bob = np.arange(lo, hi + 1) - h.ipo
            flags = [xi[j, fl] for (_, _, fl) in h.cross]
            kinds = [xi[j, kl] for (_, _, kl) in h.ex]
            if sum(f != 0 for f in flags) >= 2:
                hits.add("K>=2")
            if any(kinds):
                hits.add("K2>=1")
            if any(flags) or any(kinds):
                hits.add(f"strand{strand}")
            covc_ep = xh[j, h.x_txc_ep] - sum(
                (xi[j, sl] >= bob) * 1.0 for (sl, _, fl) in h.cross
                if xi[j, fl] == 1)
            covc_cp = xh[j, h.x_txc_cp] - sum(
                (xi[j, sl] >= bob) * 1.0 for (sl, _, fl) in h.cross
                if xi[j, fl] == 2)
            ccw_ep = hw[h.w_cntcr_ep, W_PAD + bob]
            nep = (xh[j, h.x_cntbe_ep] - hw[h.w_cntbe_ep, W_PAD + bob - 1]
                   - ccw_ep + covc_ep) + \
                (xh[j, h.x_cntbe_cp] - hw[h.w_cntbe_cp, W_PAD + bob - 1]
                 - hw[h.w_cntcr_cp, W_PAD + bob] + covc_cp)
            if h.aL and (ccw_ep - covc_ep != 0).any():
                hits.add("aL")
                nep = nep + (ccw_ep - covc_ep)
            if h.aR and (xh[j, h.x_cntc2_ep] - covc_ep != 0).any():
                hits.add("aR")
                nep = nep + (xh[j, h.x_cntc2_ep] - covc_ep)
            if (nep >= 4.5).any():
                hits.add("nep>=4.5")
            for (sl, _, fl) in h.cross:
                f = xi[j, fl]
                if f:
                    hits.add(f"flag{f}")
                if f == 4 and h.exclass == 2 and (bob == xi[j, sl]).any():
                    hits.add("match:exclass2")
            for (pl, _, kl) in h.ex:
                pk, kd = xi[j, pl], xi[j, kl]
                if kd:
                    hits.add(f"kind{kd}")
                hit = {1: (bob == pk).any(), 2: (bob == pk).any(),
                       3: (bob > pk).any() and pk > -(1 << 29)}.get(kd)
                if hit and (kd == 1 or h.exclass == {2: 1, 3: 3}[kd]):
                    hits.add(f"match:kind{kd}")
                    if kd == 1:
                        hits.add(f"match:cds:exclass{h.exclass}")
    return hits


def test_fixture_reaches_every_branch():
    """The hinted chunks of chip_smoke.py's parity phase (all of
    HS04636sm.fa, 6 kb of HS04636rc.fa) reach each branch of hint_quot."""
    hits = set()
    for which, n in (("sm", None), ("rc", 6000)):
        st, arr, m = _port_pack("repo_fixture", which, n)
        hits |= _branches(st, planes_for(st, arr, "cpu"), m.sg.state_types)
    want = {"NHW>0", "K>=2", "K2>=1", "aL", "aR", "nep>=4.5",
            "strand+", "strand-"}
    want |= {f"exclass{c}" for c in range(4)}
    want |= {f"flag{f}" for f in (1, 2, 4)}
    want |= {f"kind{k}" for k in (1, 2, 3)}
    want |= {"match:exclass2", "match:kind1", "match:kind2", "match:kind3"}
    assert want <= hits, sorted(want - hits)


def test_hint_fixture_is_deterministic():
    """make_hints_fixture.py gives the committed bytes on every run, and
    tiled_hinted gives the same letters and hints twice."""
    path = os.path.join(PKG_DATA, "make_hints_fixture.py")
    spec = importlib.util.spec_from_file_location("make_hints", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    files = mod.hint_files()
    assert files == mod.hint_files()
    for name, text in files.items():
        with open(os.path.join(HINTS, name)) as fh:
            assert fh.read() == text, name
    (r1, h1), (r2, h2) = tiled_hinted(DATA), tiled_hinted(DATA)
    assert r1.sequence == r2.sequence and h1 == h2
    low = sum(map(str.islower, r1.sequence)) / len(r1.sequence)
    assert 0.35 < low < 0.45
