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
from augustus_tpu_torch.engine.forward import (LESSD_MAXW, ForwardEngine,
                                               forward_reference,
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
    ForwardEngine raises UnsupportedByDevice, engine/scan.py:961-963):
    NotImplementedError naming it."""
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


def _whole_piece(hints):
    """(static, planes on the CPU) of all of HS04636.fa or, with hints, of
    HS04636sm.fa softmasked with them, as a sampled run gives them to
    csrc/forward.cu."""
    from augustus_tpu_torch.predict import piece_planes
    fasta = "HS04636sm.fa" if hints else "HS04636.fa"
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    st, planes, _ = piece_planes(Model.load(_args("repo_fixture", hints, 0)),
                                 rec, None, "cpu")
    return st, planes


@pytest.mark.parametrize("hints", [None, "HS04636sm.E.gff"])
def test_forward_block_fits_the_piece(hints):
    """csrc/forward.cu's block of K3_WARPS warps on a whole sampled piece:
    the shared-memory layout it shares with the Viterbi kernel fits the
    232,448 bytes a block may have, hinted (NHW = 24) too; every warp that
    can take a conv has its region in that layout; the two thread-item
    warps cover every state; and the piece is inside kernel_limits."""
    from augustus_tpu_torch.engine import forward as F
    from augustus_tpu_torch.engine import viterbi as V
    st, planes = _whole_piece(hints)
    assert st.NHW == (24 if hints else 0)
    nxh, nxi = V._hint_widths(st, planes)
    desc = V._descriptor(st, planes["sel_pack"].numpy(), nxh, nxi)
    lay = V.smem_layout(st, desc.shape[0], nxh, nxi)
    assert lay["bytes"] <= V.SMEM_LIMIT == 232_448
    item_warps = F.K3_WARPS - 2
    assert min(len(st.convs), item_warps) <= min(len(st.convs),
                                                 V.ITEM_WARPS)
    assert 2 * 32 >= st.S and F.K3_WARPS * 32 <= 1024
    F.kernel_limits(st)


def test_forward_block_width_matches_the_source():
    """engine/forward.py's K3_WARPS and LESSD_MAXW are csrc/forward.cu's."""
    import re
    from augustus_tpu_torch.engine import forward as F
    with open(os.path.join(ROOT, "augustus_tpu_torch", "csrc",
                           "forward.cu")) as fh:
        src = fh.read()
    warps = re.search(r"#else\nconstexpr int K3_WARPS = (\d+),", src)
    assert warps and int(warps.group(1)) == F.K3_WARPS
    assert f"W5 <= {F.LESSD_MAXW}" in src


@pytest.mark.parametrize("window,refused", [(LESSD_MAXW, False),
                                            (LESSD_MAXW + 1, True)])
def test_kernel_limits_refuse_a_wide_lessd_window(window, refused):
    """The wrapper raises before launch on a lessD window wider than the
    two entries per lane of csrc/forward.cu (LESSD_MAXW), and takes one of
    exactly that width."""
    import dataclasses
    from augustus_tpu_torch.engine.forward import kernel_limits
    _, tr = _tracks("repo_fixture", "HS04636.fa", None, 0, 1500)
    st, _ = pack_tracks(tr)
    assert st.lessd and LESSD_MAXW == 64
    wide = dataclasses.replace(st, lessd=[dataclasses.replace(
        st.lessd[0], window=window)] + list(st.lessd[1:]))
    if refused:
        with pytest.raises(NotImplementedError, match="lessD window"):
            kernel_limits(wide)
    else:
        kernel_limits(wide)
