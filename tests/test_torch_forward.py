"""The port's forward table (engine/forward.py, the plain PyTorch version of
csrc/forward.cu) against augustus_tpu's scan.ForwardEngine on the CPU, on
6 kb chunks: ab initio with one and with two GC classes, softmasked with EST
hints (sparse exon hints: the hint quotient), and heated (--temperature=3).

Gate: the same finite support, and |df| <= 4e-3 + 3e-6 * |f| in rebased
space (before tracks.base is added back), where f is augustus_tpu's value.
Both are float32 logsumexps summed in different orders.  Each case prints
its largest |df| and its largest share of the tolerance (pytest -s)."""

import copy
import os

import numpy as np
import pytest
import torch

from augustus_tpu import genetics as jgenetics
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.engine.scan import ForwardEngine as JForward
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch import genetics
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.forward import (ForwardEngine, forward_reference,
                                               forward_table)
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.engine.pack import forward_arrays, pack_tracks
from augustus_tpu_torch.engine.viterbi import planes_for
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, _piece_hints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
PKG_DATA = os.path.join(ROOT, "augustus_tpu_torch", "data")
CONFIG = os.path.join(PKG_DATA, "config")
DATA = os.path.join(ROOT, "tests", "data")
N = 6000
ABS_TOL, REL_TOL = 4e-3, 3e-6

# (id, species, fasta, hints file, temperature)
CASES = [("ab_initio", "repo_fixture", "HS04636.fa", None, 0),
         ("gc2", "repo_fixture_gc2", "HS04636.fa", None, 0),
         ("hinted", "repo_fixture", "HS04636sm.fa", "HS04636sm.E.gff", 0),
         ("heated", "repo_fixture", "HS04636.fa", None, 3)]


def _args(species, hints, temperature):
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG, "UTR": "off",
            "softmasking": "0", "temperature": str(temperature)}
    if hints is not None:
        args.update(softmasking="1", extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                    hintsfile=os.path.join(PKG_DATA, "hints", hints))
    return args


def _tracks(species, fasta, hints, temperature, n=N):
    """(augustus_tpu's DPTracks, the port's) of the first n bases, prepared
    like a prediction of them: softmask and the hints that end inside."""
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    seq = rec.sequence[:n]
    args = _args(species, hints, temperature)
    jm, m = JModel.load(dict(args)), Model.load(dict(args))
    je = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
               ext_cfg=jm.ext_cfg)
    e = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode,
                   ext_cfg=m.ext_cfg)
    jhints = hints_ = None
    if hints is not None:
        jhints = [copy.copy(f) for f in jm.gff_hints[rec.name]
                  if f.end < len(seq)]
        hints_ = _piece_hints(m.gff_hints[rec.name], 0, len(seq) - 1)
    je.prepare(jgenetics.encode(seq.lower()),
               softmask=jgenetics.softmask_runs(seq), gff_hints=jhints)
    e.prepare(genetics.encode(seq.lower()),
              softmask=genetics.softmask_runs(seq), gff_hints=hints_)
    return jbuild(je), build_tracks(e)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def case(request):
    name, species, fasta, hints, temperature = request.param
    jtr, tr = _tracks(species, fasta, hints, temperature)
    fe = ForwardEngine(tr, "cpu")
    return {"name": name, "hints": hints, "tr": tr, "fe": fe,
            "jf": JForward(jtr).run(), "f": fe.run()}


def test_forward_table_within_tolerance(case):
    jf, f, fe = case["jf"], case["f"], case["fe"]
    assert jf.shape == f.shape == (N, fe.static.S)
    live = np.isfinite(jf)
    assert np.array_equal(live, np.isfinite(f))
    assert live.sum() > 50_000
    base = np.asarray(case["tr"].base)[:N, None] * fe.heat
    ref = np.where(live, jf - base, 0.0)
    got = np.where(live, f - base, 0.0)
    err = np.abs(got - ref)
    share = err / (ABS_TOL + REL_TOL * np.abs(ref))
    print(f"\n{case['name']}: max |df| {err.max():.6g} (rebased), largest "
          f"share of the tolerance {share.max():.4g}, max |f| rebased "
          f"{np.abs(ref).max():.6g}")
    assert share.max() <= 1.0


def test_case_reaches_its_branch(case):
    """The hinted chunk has sparse hints (the quotient); the heated one a
    heat below 1."""
    st, fe = case["fe"].static, case["fe"]
    assert (st.NHW > 0) == (case["hints"] is not None)
    assert (fe.heat < 1.0) == (case["name"] == "heated")


def test_wrapper_runs_the_plain_version_on_cpu():
    """forward_table on CPU tensors is forward_reference (no launch)."""
    _, tr = _tracks("repo_fixture", "HS04636.fa", None, 0, 1500)
    fe = ForwardEngine(tr, "cpu")
    before = forward_table.launches
    rows = fe.rows()
    assert forward_table.launches == before
    ref, sfu = forward_reference(fe.static, planes_for(fe.static, fe.arrays,
                                                       "cpu"))
    assert torch.equal(rows, ref) and sfu > 0


def test_heat_with_sparse_hints_is_refused():
    """augustus_tpu refuses a heated forward with sparse exon hints (its
    host gold forward is not ported): NotImplementedError naming it."""
    _, tr = _tracks("repo_fixture", "HS04636sm.fa", "HS04636sm.E.gff", 0)
    st, arr = pack_tracks(tr)
    assert st.NHW > 0
    forward_arrays(st, arr, 1.0)
    with pytest.raises(NotImplementedError, match="temperature"):
        forward_arrays(st, arr, 5.0 / 8.0)


def test_heat_scales_log_tables_only():
    """Heat multiplies the log tables and the length vectors, and leaves
    v0, the frame masks, sel_pack and the integer tables alone; l0 is the
    gated logsumexp of v0 + lane transitions."""
    _, tr = _tracks("repo_fixture", "HS04636.fa", None, 0)
    st, arr = pack_tracks(tr)
    h = forward_arrays(st, arr, 0.5)
    for k in ("stab", "G_src", "cum_src", "ltc_all", "lt_T"):
        assert np.array_equal(h[k], (np.asarray(arr[k]) * np.float32(0.5))
                              .astype(np.float32))
    for k in ("v0", "sel_pack", "itab", "log_term"):
        assert h[k] is arr[k]
    fm = [v.fm_off for cv in st.convs for v in cv.variants if v.fm_off >= 0]
    assert fm and all(h["lv_pack"][0, o] == arr["lv_pack"][0, o] for o in fm)
    S, NL = st.S, st.NL
    cand = (arr["v0"][0, :S][None, :].astype(np.float64)
            + h["lt_T"][:S, :NL].T.astype(np.float64))
    live = cand.max(axis=1) > -1e29
    with np.errstate(divide="ignore"):
        want = np.log(np.exp(cand - cand.max(axis=1, keepdims=True))
                      .sum(axis=1)) + cand.max(axis=1)
    assert np.allclose(h["l0"][0, :NL][live], want[live], atol=1e-4)
    assert (h["l0"][0, :NL][~live] == np.float32(-1e30)).all()
