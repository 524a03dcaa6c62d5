"""K5, the logsumexp twin of K2 (augustus_tpu_torch/engine/scan.py): its
plain PyTorch version `scan_table_reference` against augustus_tpu's jitted
make_forward_fn on the same split tables, on 6 kb chunks of the 71-state
UTR fixture: HS04636.fa, its reverse complement and, heated with
--temperature=3, HS04636.fa again (the heated arrays bit-equal to those of
augustus_tpu's ForwardEngine).  tests/test_torch_scan_lse_hints.py holds
the hinted chunk (the hint quotient).

Gate, as for K3 (tests/test_torch_forward.py): the same finite support,
and |df| <= 4e-3 + 3e-6 * |f| in rebased space, where f is augustus_tpu's
value.  Both are float32 logsumexps with the sums in different orders.
Each case prints its largest |df| (pytest -s).  Besides: on a 47-state
chunk the general plain version stays within the same gate of K3's plain
version; scan_table_work counts each read once; the wrapper refuses what
the kernel does not take; heat with sparse exon hints is refused.  The
card's tests (tests/test_torch_cuda.py) hold csrc/scan_lse.cu against the
plain version."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.engine.scan import ForwardEngine as JForward
from augustus_tpu.engine.scan import make_forward_fn, split_tracks as jsplit
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.convert import model_from_reference, \
    scan_from_reference
from augustus_tpu_torch.engine import scan as S
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, piece_scan
from test_torch_model import reference_fields
from test_torch_scan import DATA, _args, _prepare, _reads

# the plain versions run a Python loop of small torch ops
torch.set_num_threads(1)
N = 6000
ABS_TOL, REL_TOL = 4e-3, 3e-6

# (name, fasta, hints file, temperature)
CASES = [("fwd", "HS04636.fa", None, 0),
         ("rc", "HS04636rc.fa", None, 0),
         ("heated", "HS04636.fa", None, 3)]
_JIT = {}


def make_case(name, fasta, hints, temperature, n=N):
    """Both packages' tables of the first n bases (the port's through
    model_from_reference, so that they are the same), heated as each
    package's forward engine heats them, and each package's forward rows
    of them: augustus_tpu's jitted make_forward_fn, the port's plain
    version."""
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    args = dict(_args(hints=hints), temperature=str(temperature))
    jm = JModel.load(dict(args))
    jeng = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
                 utr=jm.utr, utr_cfg=jm.utr_cfg, ext_cfg=jm.ext_cfg)
    _prepare(jeng, rec, n, jm.gff_hints)
    jtr = jbuild(jeng)
    jst, _ = jsplit(jtr)
    jfe = JForward(jtr)           # splits and heats the tables
    fields = reference_fields(jm)
    fields["utr"] = dataclasses.asdict(jm.utr)
    fields["utr_cfg"] = dataclasses.asdict(jm.utr_cfg)
    m = model_from_reference(fields)
    own = Model.load(dict(args))
    m.ext_cfg, m.gff_hints = own.ext_cfg, own.gff_hints
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode,
                     utr=m.utr, utr_cfg=m.utr_cfg, ext_cfg=m.ext_cfg)
    _prepare(eng, rec, n, m.gff_hints)
    tr = build_tracks(eng)
    fe = S.ScanForwardEngine(tr, S.split_tracks(tr), "cpu")
    fn = _JIT.get(jst)
    if fn is None:
        fn = _JIT[jst] = jax.jit(make_forward_fn(jst))
    _, jrows = fn(jax.tree_util.tree_map(jnp.asarray, jfe.arrays),
                  jnp.asarray(jtr.log_init))
    rows, sfu = S.scan_table_reference(
        fe.static, S.scan_tensors(fe.arrays, "cpu"),
        torch.from_numpy(np.asarray(tr.log_init, np.float32)))
    return {"name": name, "jst": jst, "jfe": jfe, "fe": fe, "tr": tr,
            "ref": np.asarray(jrows), "rows": rows.numpy(), "sfu": sfu}


def within_gate(ref, got, label):
    """Identical finite support and |got - ref| <= 4e-3 + 3e-6 * |ref|;
    returns (live entries, max |df|)."""
    live = ref > -5.0e29
    assert np.array_equal(live, got > -5.0e29), label
    err = np.abs(got[live] - ref[live])
    share = err / (ABS_TOL + REL_TOL * np.abs(ref[live]))
    print(f"\n{label}: max |df| {err.max():.6g}, largest share of the "
          f"tolerance {share.max():.4g}, max |f| {np.abs(ref[live]).max():.6g}")
    assert share.max() <= 1.0, label
    return int(live.sum()), float(err.max())


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def case(request):
    return make_case(*request.param)


def test_tables_and_heat_equal(case):
    """The port's heated tables are augustus_tpu's ForwardEngine's, bit for
    bit (at temperature 0 the split tables themselves)."""
    jst, jarr = scan_from_reference(dataclasses.asdict(case["jst"]),
                                    case["jfe"].arrays)
    fe = case["fe"]
    assert jst == fe.static
    assert fe.heat == case["jfe"]._heat
    assert (fe.heat < 1.0) == (case["name"] == "heated")
    for k in jarr:
        if k == "n_true":
            continue
        a, b = np.atleast_1d(jarr[k]), np.atleast_1d(fe.arrays[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_forward_rows_within_tolerance(case):
    """Row j of the port is the reference's row j - 1 (row 0 is v0)."""
    rows, ref = case["rows"], case["ref"]
    assert rows.shape == (N, 71) and ref.shape == (N - 1, 71)
    live, _ = within_gate(ref, rows[1:], case["name"])
    assert live > 50_000 and case["sfu"] > live


def test_engine_table_in_true_log_space(case):
    """ScanForwardEngine.run adds tracks.base * heat back and gives -inf
    off the support, as augustus_tpu's ForwardEngine.run does."""
    fe, tr = case["fe"], case["tr"]
    fe.rows = lambda: torch.from_numpy(case["rows"])   # the case's rows
    f = fe.run()
    rows = case["rows"].astype(np.float64)
    live = rows > -5.0e29
    assert np.array_equal(np.isfinite(f), live)
    base = np.asarray(tr.base)[: tr.n, None] * fe.heat
    assert np.array_equal(f[live], (rows + base)[live])


def test_general_plain_version_equals_k3_on_47_states():
    """On the 47-state architecture K5's plain version stays within the
    gate of K3's plain version (engine/forward.py) on the same 6 kb."""
    from augustus_tpu_torch.engine.forward import ForwardEngine
    m = Model.load(_args("repo_fixture"))
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, gold = piece_scan(m, rec, N, "cpu")
    rows, _ = S.scan_table_reference(st, t, v0)
    k3 = ForwardEngine(build_tracks(gold), "cpu").rows()[:, : st.S]
    within_gate(k3.numpy()[1:], rows.numpy()[1:], "47 states, K5 vs K3")


def test_scan_table_work_counts_each_read_once():
    """scan_table_work reads what K2 reads (the same clipped entries,
    marked position by position) and writes the rows and the lane values
    once."""
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, _ = piece_scan(Model.load(_args()), rec, 2000, "cpu")
    arrays = {k: v.numpy() for k, v in t.items()}
    parts, ops = S.scan_table_work(st, arrays)
    seen = _reads(st, arrays)
    for k in ("G_all", "cum_all", "scalar_table", "int_table"):
        assert parts[k] == int(seen[k].sum()) * 4, k
    assert parts["lessd_masks"] == int(seen["masks"].sum()) * 2
    assert parts["outputs"] == st.n * st.S * 4
    assert parts["scratch"] == (st.n - 1) * st.NL * 4
    assert ops == S.scan_work(st, arrays)[1]


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """More than 128 states or lanes raise NotImplementedError before any
    launch, on every device; CPU tensors run the plain version; a CUDA
    tensor without the kernel's library raises and falls back to
    nothing."""
    from augustus_tpu_torch.engine import _build
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, _ = piece_scan(Model.load(_args()), rec, 300, "cpu")
    before = S.scan_table.launches
    for big in (dataclasses.replace(st, S=129),
                dataclasses.replace(st, NL=129)):
        with pytest.raises(NotImplementedError, match="at most 128"):
            S.scan_table(big, t, v0)
    with pytest.raises(ValueError, match="dtype"):
        S.scan_table(st, dict(t, int_table=t["int_table"].long()), v0)
    assert torch.equal(S.scan_table(st, t, v0),
                       S.scan_table_reference(st, t, v0)[0])

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    checked = S._check(st, t, v0)
    monkeypatch.setattr(S, "_check",
                        lambda *a: (torch.device("cuda"), checked[1]))
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(
        os.path.dirname(DATA), "..", "build", "no-such-kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        S.scan_table(st, t, v0)
    assert S.scan_table.launches == before


def test_heat_with_sparse_hints_is_refused():
    """augustus_tpu refuses a heated forward with sparse exon hints (its
    ForwardEngine raises UnsupportedByDevice, engine/scan.py:961-963):
    NotImplementedError naming temperature and the hints."""
    rec = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    m = Model.load(_args(hints="HS04636sm.E.gff"))
    st, t, v0, gold = piece_scan(m, rec, 2000, "cpu")
    assert st.NHW > 0
    arrays = {k: v.numpy() for k, v in t.items()}
    assert S.heated(st, arrays, 1.0) is arrays
    with pytest.raises(NotImplementedError,
                       match="temperature.*sparse exon"):
        S.heated(st, arrays, 5.0 / 8.0)
