"""K2, the general Viterbi (augustus_tpu_torch/engine/scan.py): its plain
PyTorch version against augustus_tpu's make_scan_fn(debug_vals=True) on
the CPU, on chunks of the 71-state UTR fixture (forward and reverse
strand, and softmasked with EST hints, which reaches the hint quotient):
per-base values, backpointers and the final column bit-equal (tolerance
0: both are max-plus in float32 with the same operand order; row j of the
port is the reference's row j - 1).  Both packages' split tables are
bit-equal from the same parameters (convert.model_from_reference); on a
47-state chunk K2 equals K1's plain version; scan_work counts each read
once; the wrapper refuses what the kernel does not take.  The card's tests
(tests/test_torch_cuda.py) hold csrc/scan.cu against the plain version."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from augustus_tpu import genetics as jgenetics
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.engine.scan import make_scan_fn, split_tracks as jsplit
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.convert import model_from_reference, \
    scan_from_reference
from augustus_tpu_torch.engine import scan as S
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.model.state_config import ST
from augustus_tpu_torch.predict import Model, piece_scan
from test_torch_model import reference_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plain versions run a Python loop of small torch ops
torch.set_num_threads(1)
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
DATA = os.path.join(ROOT, "tests", "data")

# (name, fasta, chunk length, hints file): the forward and the reverse
# chunk share one static structure, so the two reference compiles are the
# unhinted 6 kb and the hinted 6 kb
CASES = [("fwd", "HS04636.fa", 6000, None),
         ("rc", "HS04636rc.fa", 6000, None),
         ("hinted", "HS04636sm.fa", 6000, "HS04636sm.E.gff")]
_JIT = {}


def _args(species="repo_fixture_utr", hints=None):
    a = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
         "UTR": "on" if species.endswith("_utr") else "off",
         "softmasking": "0"}
    if hints:
        a.update(softmasking="1", hintsfile=os.path.join(HINTS, hints),
                 extrinsicCfgFile="extrinsic.M.RM.E.W.cfg")
    return a


def _prepare(eng, rec, n, gff_hints):
    """Both packages' GoldEngines take the first n bases, the softmask and
    the hints that end inside them, as a piece."""
    seq = rec.sequence[:n]
    hints = None
    if gff_hints is not None:
        hints = [f for f in gff_hints.get(rec.name, []) if f.end <= n - 1]
    eng.set_boundaries(False, False)
    eng.prepare(jgenetics.encode(seq.lower()),
                softmask=np.array([ch.islower() for ch in seq]),
                gff_hints=hints)


def _reference(st, arrays, log_init):
    fn = _JIT.get(st)
    if fn is None:
        fn = _JIT[st] = jax.jit(make_scan_fn(st, debug_vals=True))
    vfin, (bps, vals) = fn(jax.tree_util.tree_map(jnp.asarray, arrays),
                           jnp.asarray(log_init))
    return np.asarray(vfin), np.asarray(bps), np.asarray(vals)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def case(request):
    name, fasta, n, hints = request.param
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    jm = JModel.load(_args(hints=hints))
    jeng = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
                 utr=jm.utr, utr_cfg=jm.utr_cfg, ext_cfg=jm.ext_cfg)
    _prepare(jeng, rec, n, jm.gff_hints)
    jtr = jbuild(jeng)
    jst, jarr = jsplit(jtr)
    fields = reference_fields(jm)
    fields["utr"] = dataclasses.asdict(jm.utr)
    fields["utr_cfg"] = dataclasses.asdict(jm.utr_cfg)
    m = model_from_reference(fields)
    own = Model.load(_args(hints=hints))
    m.ext_cfg, m.gff_hints = own.ext_cfg, own.gff_hints
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode,
                     utr=m.utr, utr_cfg=m.utr_cfg, ext_cfg=m.ext_cfg)
    _prepare(eng, rec, n, m.gff_hints)
    tr = build_tracks(eng)
    st, arr = S.split_tracks(tr)
    t = S.scan_tensors(arr, "cpu")
    v0 = torch.from_numpy(np.asarray(tr.log_init, np.float32))
    bp, vfin, vals = S.scan_forward(st, t, v0, debug_vals=True)
    return {"name": name, "jst": jst, "jarr": jarr, "st": st, "arr": arr,
            "tr": tr, "bp": bp.numpy(), "vfin": vfin.numpy(),
            "vals": vals.numpy(), "ref": _reference(jst, jarr, jtr.log_init)}


def test_tables_equal(case):
    """Through model_from_reference both packages split the same tracks
    into the same static structure and the same arrays, bit for bit
    (scan_from_reference carries the reference's across)."""
    jst, jarr = scan_from_reference(dataclasses.asdict(case["jst"]),
                                    case["jarr"])
    assert jst == case["st"]
    arr = case["arr"]
    assert sorted(k for k in arr if k != "n_true") == \
        sorted(k for k in jarr if k != "n_true")
    for k in jarr:
        a, b = np.atleast_1d(jarr[k]), np.atleast_1d(arr[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
    st = case["st"]
    assert st.S == 71 and st.NL > 64 and st.GPAD == 5632
    assert (st.NHW > 0) == (case["name"] == "hinted")
    assert any(v.vb_lo is not None for c in st.convs for v in c.variants)
    assert S.needs_general_scan(case["tr"])


def test_values_equal(case):
    vals, (_, _, ref) = case["vals"], case["ref"]
    assert vals.shape == (case["st"].n, 71)
    assert np.array_equal(vals[1:].view(np.int32), ref.view(np.int32))


def test_backpointers_equal(case):
    """Every backpointer, live or not, with the row shift."""
    assert np.array_equal(case["bp"][1:], case["ref"][1])
    assert not case["bp"][0].any()


def test_final_column_equal(case):
    assert np.array_equal(case["vfin"].view(np.int32),
                          case["ref"][0].view(np.int32))


def test_every_utr_state_is_live():
    """Over the fixture's chunks every UTR state type except the hints-only
    intronvar states takes a value above GATE somewhere (the fixture holds
    K2 to all of its UTR branches), on both strands."""
    live = set()
    for name, fasta, n, hints in CASES[:2]:
        rec = read_fasta(os.path.join(DATA, fasta))[0]
        st, t, v0, gold = piece_scan(Model.load(_args()), rec, 2500, "cpu")
        _, _, vals = S.scan_forward(st, t, v0, debug_vals=True)
        on = (vals.numpy() > S.GATE).any(axis=0)
        live |= {gold.sg.state_types[s] for s in np.flatnonzero(on)}
    utr = {t for t in ST if (ST.utr5single <= t <= ST.utr3term)
           or (ST.rutr5single <= t <= ST.rutr3term)}
    var = {ST.utr5intronvar, ST.utr3intronvar, ST.rutr5intronvar,
           ST.rutr3intronvar}
    assert utr - var <= live
    assert not (live & var)


def test_k2_equals_k1_on_a_47_state_chunk():
    """On the 47-state architecture K2's plain version gives K1's plain
    version's values, backpointers and final column."""
    from augustus_tpu_torch.engine.viterbi import (
        viterbi_forward_reference, planes_for)
    from augustus_tpu_torch.engine.pack import pack_tracks
    m = Model.load(_args("repo_fixture"))
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(jgenetics.encode(rec.sequence[:2500].lower()))
    tr = build_tracks(eng)
    assert not S.needs_general_scan(tr)
    st, arr = S.split_tracks(tr)
    bp, vf, vals = S.scan_forward(
        st, S.scan_tensors(arr, "cpu"),
        torch.from_numpy(np.asarray(tr.log_init, np.float32)), True)
    pst, parr = pack_tracks(tr)
    kbp, kvf, kvals = viterbi_forward_reference(
        pst, planes_for(pst, parr, "cpu"), True)
    n, s = st.n, st.S
    assert np.array_equal(vals.numpy()[1:].view(np.int32),
                          kvals.numpy()[1:, :s].view(np.int32))
    live = kvals.numpy()[1:, :s] > -5.0e29
    assert ((bp.numpy()[1:] == kbp.numpy()[1:, :s]) | ~live).all()
    assert np.array_equal(vf.numpy(), kvf.numpy()[:s])
    assert vals.shape == (n, s)


def _reads(st, arrays):
    """The elements K2 reads, marked position by position as the plain
    version reads them (band entries inside their bounds at gated
    positions; lessD windows; the columns of each record)."""
    n, PAD, GPAD = st.n, st.PAD, st.GPAD
    it = np.asarray(arrays["int_table"])
    seen = {"G_all": np.zeros(np.asarray(arrays["G_all"]).shape, bool),
            "cum_all": np.zeros(np.asarray(arrays["cum_all"]).shape, bool),
            "masks": np.zeros(np.asarray(
                arrays["lessd_bvalid_all"]).shape, bool),
            "scalar_table": np.zeros((n, st.NSC), bool),
            "int_table": np.zeros((n, st.NIC), bool)}
    for j in range(1, n):
        c = it[j, st.cls_col]
        seen["int_table"][j, st.cls_col] = True
        for ch in st.chain:
            seen["scalar_table"][j, ch.emi_col] = True
        for f in st.fixed:
            seen["scalar_table"][j, f.emi_col] = True
            if f.extra_col >= 0:
                seen["scalar_table"][j, f.extra_col] = True
        for p in st.pinned:
            seen["scalar_table"][j, p.score_col] = True
            seen["int_table"][j, p.eop_col] = True
        for li, d in enumerate(st.lessd):
            W = d.window
            seen["scalar_table"][j, [d.cumj_col, d.psi_col]] = True
            seen["int_table"][j, [d.jsel_col, d.jgate_col]] = True
            seen["cum_all"][d.cum_id, c, j - W + GPAD + 1: j + GPAD + 1] = \
                True
            seen["masks"][li, j - W + PAD: j + PAD] = True
        for cv in st.convs:
            seen["int_table"][j, cv.gate_col] = True
            gp = it[j, cv.gate_col]
            if not gp & 1:
                continue
            seen["int_table"][j, [cv.smin_col, cv.smax_col]] = True
            smin, smax = it[j, cv.smin_col], it[j, cv.smax_col]
            for v in cv.variants:
                seen["scalar_table"][j, v.h_col] = True
                b0 = j + cv.a_off - v.len_hi
                lo, hi = max(smin, b0), min(smax, b0 + v.width - 1)
                if v.vb_lo is not None:
                    lo = max(lo, v.vb_lo)
                if v.vb_hi is not None:
                    hi = min(hi, v.vb_hi)
                if hi >= lo:
                    seen["G_all"][v.g_id, c, gp >> 1,
                                  lo + GPAD: hi + GPAD + 1] = True
    return seen


def test_scan_work_counts_each_read_once():
    """scan_work's bytes equal the elements the plain version reads,
    marked position by position, on 2,000 bases of the UTR fixture;
    outputs and the lane history are written once."""
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, gold = piece_scan(Model.load(_args()), rec, 2000, "cpu")
    arrays = {k: v.numpy() for k, v in t.items()}
    parts, ops = S.scan_work(st, arrays)
    seen = _reads(st, arrays)
    for k in ("G_all", "cum_all", "scalar_table", "int_table"):
        assert parts[k] == int(seen[k].sum()) * 4, k
    assert parts["lessd_masks"] == int(seen["masks"].sum()) * 2
    assert parts["outputs"] == (st.n * st.S + st.S) * 4
    assert parts["scratch"] == (st.n - 1) * st.NL * 5
    assert parts["hw_all"] == 0 and ops["hint_quot"] == 0
    assert ops["dp"] > (st.n - 1) * st.NL * st.S * 2
    whole = sum(np.asarray(a).nbytes for a in arrays.values())
    assert 0 < sum(parts.values()) < whole


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """More than 128 states or lanes raise NotImplementedError before any
    launch, on every device; a CUDA tensor without the kernel's library
    raises and falls back to nothing."""
    from augustus_tpu_torch.engine import _build
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, _ = piece_scan(Model.load(_args()), rec, 300, "cpu")
    before = S.scan_forward.launches
    for big in (dataclasses.replace(st, S=129),
                dataclasses.replace(st, NL=129)):
        with pytest.raises(NotImplementedError, match="at most 128"):
            S.scan_forward(big, t, v0)
    with pytest.raises(ValueError, match="dtype"):
        S.scan_forward(st, dict(t, int_table=t["int_table"].long()), v0)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    checked = S._check(st, t, v0)
    monkeypatch.setattr(S, "_check",
                        lambda *a: (torch.device("cuda"), checked[1]))
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(
        ROOT, "build", "no-such-kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        S.scan_forward(st, t, v0)
    assert S.scan_forward.launches == before
