"""The port's device route (torch tensors on the CPU: every kernel runs its
plain version) against augustus_tpu: its packed tables against the JAX
host prep (pallas_pack.pack_tracks(build_tracks(gold))) and, within the
JAX route's own tolerance, against augustus_tpu's traced device route; its
overlays against build_overlays; its GFF against augustus_tpu's; and the
routing of chunks with exon-kind hints to the host route."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from augustus_tpu import genetics as jgenetics
from augustus_tpu.engine import jgold as jjgold
from augustus_tpu.engine import pallas_pack as jpack
from augustus_tpu.engine import xputil as JU
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGoldEngine
from augustus_tpu.model import gc as jgc
from augustus_tpu.predict import Model as JModel, predict_file as jpredict
from augustus_tpu_torch import stats
from augustus_tpu_torch.engine import xputil as U
from augustus_tpu_torch.engine.jgold import build_overlays
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.io.tiled import exon_free_hints
from augustus_tpu_torch.predict import (Model, _decode, _new_gold,
                                        _piece_input, piece_tables,
                                        predict_file)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
DATA = os.path.join(ROOT, "tests", "data")

# name -> (species, fasta, bases, hints): hints None (ab initio), "exon_free"
# (softmasked, HS04636sm.E.gff without exonpart/CDSpart/exon/CDS) or "all"
CHUNKS = {
    "ab_initio": ("repo_fixture", "HS04636.fa", 6000, None),
    "gc2": ("repo_fixture_gc2", "HS04636.fa", 6000, None),
    "softmasked_exon_free": ("repo_fixture", "HS04636sm.fa", 6000,
                             "exon_free"),
}
# tables of the device route that are not bit-equal to the host route's on
# these chunks, with the largest difference measured: none
NOT_BIT_EQUAL = {}


def tol(x):
    """augustus_tpu's device-route tolerance (tests/test_jprep.py)."""
    return 4e-3 + 3e-6 * np.abs(x)


@pytest.fixture(scope="module")
def hint_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("hints")
    with open(os.path.join(HINTS, "HS04636sm.E.gff")) as fh:
        lines = fh.read().splitlines(True)
    path = d / "HS04636sm.exon_free.gff"
    path.write_text("".join(exon_free_hints(lines)))
    return {"exon_free": str(path),
            "all": os.path.join(HINTS, "HS04636sm.E.gff")}


def _args(species, hints, hint_files):
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}
    if hints is not None:
        args.update(softmasking="1", hintsfile=hint_files[hints],
                    extrinsicCfgFile="extrinsic.M.RM.E.W.cfg")
    return args


def _jax_host_gold(args, rec, n):
    """augustus_tpu's host-prepared GoldEngine of the first n bases."""
    jm = JModel.load(args)
    seq = rec.sequence[:n]
    hints = None
    if jm.gff_hints is not None:
        hints = [f for f in jm.gff_hints.get(rec.name, [])
                 if 0 <= f.end <= len(seq) - 1]
    je = JGoldEngine(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp,
                     jm.gcode, ext_cfg=jm.ext_cfg)
    je.set_boundaries(False, False)
    je.prepare(jgenetics.encode(seq.lower()),
               softmask=jgenetics.softmask_runs(seq), gff_hints=hints)
    return jm, je


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=sorted(CHUNKS))
def routes(request, hint_files):
    species, fasta, n, hints = CHUNKS[request.param]
    args = _args(species, hints, hint_files)
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    _, je = _jax_host_gold(args, rec, n)
    jst, jarr = jpack.pack_tracks(jbuild(je))
    calls = []

    def prefix_sum(x):
        calls.append(tuple(x.shape))
        return U.prefix_sum_f64(x)
    got, gold, route = piece_tables(Model.load(args), rec, n, "cpu",
                                    prefix_sum)
    return request.param, (jst, jarr), got, gold, route, calls


def test_device_route_taken(routes):
    name, _, got, gold, route, _ = routes
    assert route == "device_prep"
    st, arr = got
    assert isinstance(arr["stab"], torch.Tensor)
    assert (gold.hints is not None) == (CHUNKS[name][3] is not None)
    if name == "gc2":
        assert st.C == 2


def test_static_equal_to_host_prep(routes):
    _, (jst, _), (st, _), _, _, _ = routes
    assert dataclasses.asdict(jst) == dataclasses.asdict(st)


def test_tables_equal_to_host_prep(routes):
    """Integer tables exact; float tables bit-equal, but for the tables in
    NOT_BIT_EQUAL, held to augustus_tpu's device-route tolerance."""
    name, (_, jarr), (_, arr), _, _, _ = routes
    assert set(arr) <= set(jarr)
    for k, v in arr.items():
        got, ref = _host(v), np.asarray(jarr[k])
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        if ref.dtype.kind != "f":
            assert np.array_equal(got, ref), k
        elif (name, k) in NOT_BIT_EQUAL:
            assert np.all(np.abs(got - ref) <= tol(ref)), k
        else:
            assert np.array_equal(got.view(np.int32), ref.view(np.int32)), k


def test_prefix_sums_in_two_calls(routes):
    """Every cumulative row of a piece goes to one prefix sum (one kernel
    launch on the card): per GC class the two intron rows and three rows for
    each of the six exon content cums, and with hints the two intronpart
    rows; the igenic base potential is the second call."""
    name, _, (st, _), gold, _, calls = routes
    rows = 20 * st.C + (2 if gold.hints is not None else 0)
    assert calls == [(rows, st.n + 1), (st.n,)]


@pytest.mark.parametrize("case", ["neg_zero", "neg_zero_run", "random"])
def test_prefix_sum_equal_to_np_cumsum(case):
    """The prefix sum's plain version (what a CPU tensor runs) is np.cumsum
    bit for bit, a row's leading run of -0.0 included."""
    rng = np.random.default_rng(3)
    x = {"neg_zero": np.array([[-0.0]]),
         "neg_zero_run": np.array([[-0.0, -0.0, 0.0, -0.0, 2.5],
                                   [-0.0, -0.0, -0.0, -1.0, 1.0]]),
         "random": rng.standard_normal((3, 2049)) * 10}[case]
    got = U.prefix_sum_f64(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int64),
                          np.cumsum(x, axis=-1).view(np.int64))


def test_overlays_equal_to_the_reference(hint_files):
    args = _args("repo_fixture", "exon_free", hint_files)
    rec = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    n = 6000
    _, je = _jax_host_gold(args, rec, n)
    jmeta, jov = jjgold.build_overlays(je.hints, n)
    gold = _new_gold(Model.load(args), False, False)
    gold.collect_hints(*_piece_input(Model.load(args), rec, n))
    meta, ov = build_overlays(gold.hints, n)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    assert meta.has_hints and not meta.sparse_exon
    assert set(ov) == set(jov)
    for k, v in ov.items():
        assert v.dtype == jov[k].dtype and np.array_equal(v, jov[k]), k
    # the device route's float64 values round to the reference's float32
    _, ov64 = build_overlays(gold.hints, n, np.float64)
    for k, v in ov64.items():
        assert np.array_equal(v.astype(jov[k].dtype), jov[k]), k
    assert sum(int((ov[f"{k}_s"] < n).sum()) for k in ("ig_nep", "ipb_p")) > 2
    assert int((ov["site_dss_p_p"] < n).sum()) > 0


def test_within_tolerance_of_the_jax_device_route(hint_files):
    """augustus_tpu's own device route (JGold under jax.jit, float32 with
    double-float32 cumsums) on 3,000 softmasked bases with the exon-free
    hints: statics equal, integer tables exact, float tables within its
    tolerance of the port's."""
    args = _args("repo_fixture", "exon_free", hint_files)
    rec = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    n = 3000
    jm, je = _jax_host_gold(args, rec, n)
    meta, ov = jjgold.build_overlays(je.hints, n)
    codes = je.codes
    stairs = jgc.compute_stairs(codes, jm.cn, jm.decomp)
    cls_blk = jpack.compute_cls_blk(stairs, n)
    jg = jjgold.JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp,
                      jm.gcode, ext_cfg=jm.ext_cfg)
    jg.set_boundaries(False, False)
    cell = {}

    def run(codes_d, stairs_d, ovd, cb):
        with JU.use_jax():
            jg.device_prepare(codes_d, stairs_d, meta, ovd)
            static, arrays = jpack.pack_tracks(jbuild(jg), cls_blk=cb)
        cell["static"] = static
        return arrays

    darr = jax.jit(run)(jnp.asarray(codes.astype(np.int32)),
                        jnp.asarray(stairs.astype(np.int32)),
                        {k: jnp.asarray(v) for k, v in ov.items()},
                        jnp.asarray(cls_blk))
    darr = jax.tree_util.tree_map(np.asarray, darr)
    (st, arr), _, route = piece_tables(Model.load(args), rec, n, "cpu")
    assert route == "device_prep"
    for f in ("S", "NL", "C", "NGR", "NMS", "NSEL", "LVP", "chain_states",
              "fixed_groups", "lessd", "pinned", "convs", "gate_lane",
              "cls_lane", "NHW", "PHW", "n", "n_pad"):
        assert dataclasses.asdict(st)[f] == \
            dataclasses.asdict(cell["static"])[f], f
    for k, v in arr.items():
        got, ref = _host(v), np.asarray(darr[k])
        assert got.shape == ref.shape, k
        if got.dtype.kind != "f":
            assert np.array_equal(got, ref), k
            continue
        gf = np.maximum(np.nan_to_num(got, neginf=-1e30), -1e30)
        rf = np.maximum(np.nan_to_num(ref, neginf=-1e30), -1e30)
        live = gf > -1e29
        assert (live == (rf > -1e29)).all(), k
        assert np.all(np.abs(np.where(live, gf - rf, 0.0))
                      <= tol(np.where(live, gf, 0.0))), k


GFF_CASES = {"HS04636": ("HS04636.fa", None),
             "HS04636sm_exon_free": ("HS04636sm.fa", "exon_free")}


def body(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def evidence(text: str) -> str:
    """The evidence blocks ('#' lines) of a GFF text."""
    out, on = [], False
    for l in text.splitlines(True):
        on = on or l.startswith("# Evidence for and against")
        if on:
            out.append(l)
        on = on and not l.startswith("# incompatible hint groups")
    return "".join(out)


@pytest.mark.parametrize("case", sorted(GFF_CASES))
def test_gff_equal_to_the_reference(case, hint_files):
    """predict_file(device="cpu") on the device route: GFF byte-equal to
    augustus_tpu's, evidence blocks ('#' lines) included."""
    fasta, hints = GFF_CASES[case]
    args = _args("repo_fixture", hints, hint_files)
    ref = jpredict(JModel.load(args), os.path.join(DATA, fasta),
                   engine="scan")
    stats.reset(True)
    try:
        got = predict_file(Model.load(args), os.path.join(DATA, fasta),
                           device="cpu")
        # the pieces' routes (the device preparation's op counts aside)
        routes = {k: v for k, v in stats.COUNTS.items()
                  if k.endswith("_prep")}
    finally:
        stats.reset(False)
    assert routes == {"device_prep": 1}
    assert body(got) == body(ref)
    assert evidence(got) == evidence(ref)
    assert got.count("\tgene\t") >= 1
    if hints:
        assert "# Evidence for and against" in got


def test_exon_hinted_chunk_takes_the_host_route(hint_files):
    args = _args("repo_fixture", "all", hint_files)
    model = Model.load(args)
    rec = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    (_, arr), gold, route = piece_tables(model, rec, 2500, "cpu")
    assert route == "host_prep" and gold.hints is not None
    assert isinstance(arr["stab"], np.ndarray)
    stats.reset(True)
    try:
        codes, softmask, hints = _piece_input(model, rec, 2500)
        path = _decode(_new_gold(model, False, False), codes, softmask,
                       hints, torch.device("cpu"))
        routes = dict(stats.COUNTS)
    finally:
        stats.reset(False)
    assert routes == {"host_prep": 1} and len(path) >= 1
