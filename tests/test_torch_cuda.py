"""On an NVIDIA card: the CUDA kernels against their plain PyTorch
versions on the card, as chip_smoke.py's parity phases do.  Skipped
without a card (decided inside the tests, never at import)."""

import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _planes(species, n, device, hinted=False):
    """Planes of the first n bases of HS04636.fa or, hinted, of the
    softmasked HS04636sm.fa with its EST hints."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_planes
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}
    fasta = "HS04636.fa"
    if hinted:
        fasta = "HS04636sm.fa"
        args.update(softmasking="1", extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                    hintsfile=os.path.join(ROOT, "augustus_tpu_torch", "data",
                                           "hints", "HS04636sm.E.gff"))
    rec = read_fasta(os.path.join(ROOT, "tests", "data", fasta))[0]
    st, planes, _ = piece_planes(Model.load(args), rec, n, device)
    return st, planes


@pytest.mark.cuda
@pytest.mark.parametrize("species,n", [("repo_fixture", 2500),
                                       ("repo_fixture_gc2", 6000)])
def test_kernel_equals_plain_version(cuda, species, n):
    _assert_kernel_equals_plain(*_planes(species, n, cuda))


@pytest.mark.cuda
def test_hinted_kernel_equals_plain_version(cuda):
    """With sparse hints (NHW > 0) the kernel runs the quotient K1.f."""
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    st, planes = _planes("repo_fixture", 6000, cuda, hinted=True)
    assert st.NHW > 0
    before = viterbi_forward.hinted_launches
    _assert_kernel_equals_plain(st, planes)
    assert viterbi_forward.hinted_launches == before + 1


def _assert_kernel_equals_plain(st, planes):
    from augustus_tpu_torch.engine.viterbi import (
        viterbi_forward, viterbi_forward_reference)
    before = viterbi_forward.launches
    bp, vf, vals = viterbi_forward(st, planes, debug_vals=True)
    torch.cuda.synchronize()
    assert viterbi_forward.launches == before + 1
    rbp, rvf, rvals = viterbi_forward_reference(st, planes, True)
    S = st.S
    v, rv = vals[1:, :S].cpu().numpy(), rvals[1:, :S].cpu().numpy()
    assert np.array_equal(v.view(np.int32), rv.view(np.int32))
    live = rv > -5.0e29
    assert ((bp[1:, :S].cpu().numpy() == rbp[1:, :S].cpu().numpy())
            | ~live).all()
    assert torch.equal(vf[:S].cpu(), rvf[:S].cpu())


@pytest.mark.cuda
def test_predict_file_on_the_card_reproduces_the_golden(cuda):
    from augustus_tpu_torch.predict import Model, predict_file
    m = Model.load({"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0"})
    got = predict_file(m, os.path.join(ROOT, "tests", "data", "HS04636.fa"))
    with open(os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                           "repo_fixture_HS04636.gff")) as fh:
        golden = fh.read()

    def body(t):
        return "".join(l for l in t.splitlines(True) if not l.startswith("#"))
    assert body(got) == body(golden)


@pytest.mark.cuda
def test_prefix_sum_kernel_equals_plain_version(cuda):
    """csrc/prefix.cu adds each row left to right: bit-equal to torch.cumsum
    on the CPU and to np.cumsum, ragged tiles and a leading -0.0 included."""
    from augustus_tpu_torch.engine import xputil as U
    rng = np.random.default_rng(0)
    xs = [torch.full((1, 1), -0.0, dtype=torch.float64)] + [
        torch.from_numpy(rng.standard_normal(shape) * 10)
        for shape in [(1, 1), (3, 257), (2, 1000), (5, 70001)]]
    for x in xs:
        x = x.to(cuda)
        before = U.prefix_sum_f64.launches
        got = U.prefix_sum_f64(x).cpu()
        assert U.prefix_sum_f64.launches == before + 1
        plain = U.prefix_sum_f64_reference(x.cpu())
        assert torch.equal(got.view(torch.int64), plain.view(torch.int64))
        ref = np.cumsum(x.cpu().numpy(), axis=-1)
        assert np.array_equal(got.numpy().view(np.int64), ref.view(np.int64))


@pytest.mark.cuda
def test_event_walk_kernel_equals_plain_version(cuda):
    """csrc/trace.cu on the plane of a decode on the card: events, count,
    final base and final state equal to the plain version's."""
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    st, planes = _planes("repo_fixture", None, cuda)
    bp, vfin, _ = viterbi_forward(st, planes)
    state0, n = int(torch.argmax(vfin[: st.S])), st.n
    brk = tb.walk_breaks(bp, n).contiguous()
    before = tb.event_walk.launches
    ev, res = tb.launch_event_walk(bp, brk, state0, n)
    assert tb.event_walk.launches == before + 1
    bh = bp.cpu()
    rev, rfb, rst, rcnt = tb.event_walk_reference(bh, tb.walk_breaks(bh, n),
                                                  state0, n)
    assert res.cpu().tolist() == [rfb, rst, rcnt, 0] and rcnt > 3
    assert torch.equal(ev.cpu(), rev)


@pytest.mark.cuda
def test_event_walk_past_its_bound_on_the_card(cuda):
    """With a bound of 7 events the walk relaunches on the card from where
    each launch stopped: the same events as one walk on the CPU."""
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    st, planes = _planes("repo_fixture", None, cuda)
    bp, vfin, _ = viterbi_forward(st, planes)
    state0, n = int(torch.argmax(vfin[: st.S])), st.n
    before = tb.event_walk.launches
    ev, fb, cnt = tb.event_walk(bp, state0, n, 7)
    assert tb.event_walk.launches - before == (cnt + 6) // 7 and cnt > 14
    rev, rfb, rcnt = tb.event_walk(bp.cpu(), state0, n)
    assert (fb, cnt) == (rfb, rcnt) and np.array_equal(ev, rev)


@pytest.mark.cuda
def test_device_route_tables_equal_to_host_route_on_the_card(cuda):
    import dataclasses
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_tables
    m = Model.load({"species": "repo_fixture_gc2",
                    "AUGUSTUS_CONFIG_PATH": CONFIG, "UTR": "off",
                    "softmasking": "0"})
    rec = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0]
    (hst, harr), _, hroute = piece_tables(
        dataclasses.replace(m, route="host"), rec, 6000, cuda)
    (dst, darr), _, droute = piece_tables(m, rec, 6000, cuda)
    assert (hroute, droute) == ("host_prep", "device_prep")
    assert dataclasses.asdict(hst) == dataclasses.asdict(dst)
    for k, v in harr.items():
        got = darr[k]
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        assert np.array_equal(np.asarray(got).view(np.uint8),
                              np.asarray(v).view(np.uint8)), k


@pytest.mark.cuda
def test_forward_kernel_equals_plain_version(cuda):
    """csrc/forward.cu against its plain version on the card, hinted:
    the same finite support and |df| <= 4e-3 + 3e-6 * |f|."""
    from augustus_tpu_torch.engine.forward import (forward_reference,
                                                   forward_table)
    from augustus_tpu_torch.engine.pack import KERNEL_CONSTANTS, forward_arrays
    st, planes = _planes("repo_fixture", 3000, cuda, hinted=True)
    assert st.NHW > 0
    # the forward's own l0 over the same planes
    arr = {k: planes[k].cpu().numpy() for k in KERNEL_CONSTANTS}
    planes = dict(planes, l0=torch.from_numpy(
        forward_arrays(st, arr, 1.0)["l0"]).to(cuda))
    before = forward_table.launches
    got = forward_table(st, planes)
    torch.cuda.synchronize()
    assert forward_table.launches == before + 1
    ref, _ = forward_reference(st, planes)
    g, r = got[:, : st.S].cpu().numpy(), ref[:, : st.S].cpu().numpy()
    live = r > -5.0e29
    assert np.array_equal(live, g > -5.0e29) and live.sum() > 10_000
    assert (np.abs(g - r)[live] <= 4e-3 + 3e-6 * np.abs(r[live])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hinted", [False, True])
def test_forward_kernel_bit_equal_to_two_pass_build(cuda, hinted):
    """csrc/forward.cu keeps the two-pass design's terms and their order:
    its table equals that of its K3_TWO_PASS build bit for bit."""
    from augustus_tpu_torch.engine.forward import forward_table
    from augustus_tpu_torch.engine.pack import KERNEL_CONSTANTS, forward_arrays
    st, planes = _planes("repo_fixture", 3000, cuda, hinted=hinted)
    arr = {k: planes[k].cpu().numpy() for k in KERNEL_CONSTANTS}
    planes = dict(planes, l0=torch.from_numpy(
        forward_arrays(st, arr, 1.0)["l0"]).to(cuda))
    got = forward_table(st, planes)
    two = forward_table(st, planes, ("K3_TWO_PASS",))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), two.view(torch.int32))
    assert (got[:, : st.S] > -5.0e29).sum() > 10_000


@pytest.mark.cuda
def test_sampled_prediction_on_the_card_reproduces_the_golden(cuda):
    from augustus_tpu_torch.predict import Model, predict_file
    m = Model.load({"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0", "sample": "100",
                    "alternatives-from-sampling": "true"})
    got = predict_file(m, os.path.join(ROOT, "tests", "data", "HS04636.fa"))
    with open(os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                           "repo_fixture_HS04636_sample100.gff")) as fh:
        golden = fh.read()

    def body(t):
        return "".join(l for l in t.splitlines(True) if not l.startswith("#"))
    assert body(got) == body(golden)


@pytest.mark.cuda
@pytest.mark.parametrize("fasta,n,hints", [
    ("HS04636.fa", 6000, None), ("HS04636sm.fa", None, "HS04636sm.E.gff"),
    ("HS04636rc.fa", 6000, None)])
def test_scan_kernel_equals_plain_version(cuda, fasta, n, hints):
    """K2 (csrc/scan.cu) on UTR pieces of the 71-state fixture against its
    plain version on host copies and against its earlier design (the K2_SIMPLE
    build): values, backpointers and final column bit-equal; one launch per
    call on the wrapper."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    args = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "on", "softmasking": "0"}
    if hints:
        args.update(softmasking="1", extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                    hintsfile=os.path.join(ROOT, "augustus_tpu_torch", "data",
                                           "hints", hints))
    rec = read_fasta(os.path.join(ROOT, "tests", "data", fasta))[0]
    st, t, v0, _ = piece_scan(Model.load(args), rec, n, cuda)
    before = S.scan_forward.launches
    bp, vf, vals = S.scan_forward(st, t, v0, debug_vals=True)
    torch.cuda.synchronize()
    assert S.scan_forward.launches == before + 1
    rbp, rvf, rvals = S.scan_forward_reference(
        st, {k: v.cpu() for k, v in t.items()}, v0.cpu(), True)
    assert np.array_equal(vals.cpu().numpy().view(np.int32),
                          rvals.numpy().view(np.int32))
    assert np.array_equal(bp.cpu().numpy(), rbp.numpy())
    assert torch.equal(vf.cpu(), rvf)
    sbp, svf, svals = S.scan_forward(st, t, v0, debug_vals=True,
                                     defines=("K2_SIMPLE",))
    torch.cuda.synchronize()
    assert S.scan_forward.launches == before + 2
    assert torch.equal(svals.view(torch.int32), vals.view(torch.int32))
    assert torch.equal(sbp, bp)
    assert torch.equal(svf.view(torch.int32), vf.view(torch.int32))


@pytest.mark.cuda
def test_utr_prediction_on_the_card_reproduces_the_golden(cuda):
    """--UTR=on --print_utr=on on HS04636.fa through K2 on the card."""
    from augustus_tpu_torch.engine.scan import scan_forward
    from augustus_tpu_torch.predict import Model, predict_file
    args = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "on", "softmasking": "0", "print_utr": "on"}
    before = scan_forward.launches
    got = predict_file(Model.load(args),
                       os.path.join(ROOT, "tests", "data", "HS04636.fa"))
    assert scan_forward.launches == before + 1
    with open(os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                           "repo_fixture_utr_HS04636.gff")) as fh:
        want = fh.read()

    def body(t):
        return "".join(l for l in t.splitlines(True) if not l.startswith("#"))
    assert body(got) == body(want)


@pytest.mark.cuda
@pytest.mark.parametrize("fasta,n,hints,temperature", [
    ("HS04636.fa", 3000, None, 0), ("HS04636sm.fa", 3000, "HS04636sm.E.gff", 0),
    ("HS04636rc.fa", 3000, None, 3)])
def test_scan_table_kernel_equals_plain_version(cuda, fasta, n, hints,
                                                temperature):
    """K5 (csrc/scan_lse.cu) on UTR pieces of the 71-state fixture against
    its plain version on host copies and against its earlier design (the
    K5_SIMPLE build): the same finite support and |df| <= 4e-3 + 3e-6 *
    |f|; two launches bit-identical, one count each."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    args = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "on", "softmasking": "0", "temperature": str(temperature)}
    if hints:
        args.update(softmasking="1", extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                    hintsfile=os.path.join(ROOT, "augustus_tpu_torch", "data",
                                           "hints", hints))
    rec = read_fasta(os.path.join(ROOT, "tests", "data", fasta))[0]
    model = Model.load(args)
    st, t, v0, _ = piece_scan(model, rec, n, "cpu")
    arrays = S.heated(st, {k: v.numpy() for k, v in t.items()},
                      (8.0 - model.cn.temperature) / 8.0)
    host = S.scan_tensors(arrays, "cpu")
    dev = S.scan_tensors(arrays, cuda)
    before = S.scan_table.launches
    got = S.scan_table(st, dev, v0.to(cuda))
    again = S.scan_table(st, dev, v0.to(cuda))
    torch.cuda.synchronize()
    assert S.scan_table.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    simple = S.scan_table(st, dev, v0.to(cuda), defines=("K5_SIMPLE",))
    torch.cuda.synchronize()
    assert S.scan_table.launches == before + 3
    ref, sfu = S.scan_table_reference(st, host, v0)
    g = got.cpu().numpy()
    for r in (ref.numpy(), simple.cpu().numpy()):
        live = r > -5.0e29
        assert np.array_equal(live, g > -5.0e29)
        assert live.sum() > 10_000 and sfu > 0
        assert (np.abs(g[live] - r[live]) <=
                4e-3 + 3e-6 * np.abs(r[live])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["nc_hints", "nc_fixture"])
def test_nc_scan_kernel_equals_plain_version(cuda, which):
    """K2 on the ncRNA pieces (--nc=on, 83 states, the nc hint quotient,
    exclass 4) against its plain version on host copies: values,
    backpointers and final column bit-equal; the prediction through it
    prints the golden."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan, predict_file
    from torch_nc_check import nc_run
    args, fasta = nc_run(which)
    model = Model.load(args)
    st, t, v0, _ = piece_scan(model, read_fasta(fasta)[0], None, cuda)
    assert st.S == 83 and st.NHW > 0
    bp, vf, vals = S.scan_forward(st, t, v0, debug_vals=True)
    rbp, rvf, rvals = S.scan_forward_reference(
        st, {k: v.cpu() for k, v in t.items()}, v0.cpu(), True)
    assert np.array_equal(vals.cpu().numpy().view(np.int32),
                          rvals.numpy().view(np.int32))
    assert np.array_equal(bp.cpu().numpy(), rbp.numpy())
    assert torch.equal(vf.cpu(), rvf)
    before = S.scan_forward.launches
    got = predict_file(model, fasta)
    assert S.scan_forward.launches == before + 1
    golden = {"nc_hints": "repo_fixture_utr_nc_HS04636_hints.gff",
              "nc_fixture": "repo_fixture_utr_nc_HS08198_fixture.gff"}[which]
    with open(os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                           golden)) as fh:
        want = fh.read()

    def body(t):
        return "".join(l for l in t.splitlines(True) if not l.startswith("#"))
    assert body(got) == body(want) and "\tnoncoding_transcript\t" in got


def _utr_scan(fasta, n, hints, device, species="repo_fixture_utr"):
    """K2's inputs (st, tables, v0) of the first n bases of fasta."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    utr = "on" if species.endswith("_utr") else "off"
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": utr, "softmasking": "0"}
    if hints:
        args.update(softmasking="1", extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                    hintsfile=os.path.join(ROOT, "augustus_tpu_torch", "data",
                                           "hints", hints))
    rec = read_fasta(os.path.join(ROOT, "tests", "data", fasta))[0]
    st, t, v0, _ = piece_scan(Model.load(args), rec, n, device)
    return st, t, v0


def _bit_equal(a, b):
    return a is None and b is None or torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.cuda
@pytest.mark.parametrize("hinted", [False, True])
def test_batched_viterbi_bit_equal_to_single_launches(cuda, hinted):
    """One launch of csrc/viterbi.cu over four chunks of mixed lengths (one
    block each; hinted: all with sparse hints, K1.f): every chunk's values,
    backpointers and final column bit-equal to its own launch."""
    from augustus_tpu_torch.engine import viterbi as V
    if hinted:
        chunks = [_planes("repo_fixture", n, cuda, hinted=True)
                  for n in (None, 6000, 4000, 7500)]
        assert all(st.NHW > 0 for st, _ in chunks)
    else:
        chunks = [_planes("repo_fixture", 2500, cuda),
                  _planes("repo_fixture_gc2", 6000, cuda),
                  _planes("repo_fixture", None, cuda),
                  _planes("repo_fixture", 4000, cuda)]
    single = [V.viterbi_forward(st, p, debug_vals=True) for st, p in chunks]
    before = (V.viterbi_forward.batched_launches,
              V.viterbi_forward.hinted_launches)
    batch = V.viterbi_forward_batch(chunks, debug_vals=True)
    torch.cuda.synchronize()
    assert V.viterbi_forward.batched_launches == before[0] + 1
    assert V.viterbi_forward.hinted_launches == before[1] + hinted
    assert V.viterbi_forward.largest_grid >= 4
    for (st, _), one, got in zip(chunks, single, batch):
        for a, b in zip(one, got):
            assert _bit_equal(a, b)


@pytest.mark.cuda
def test_batched_scan_bit_equal_to_single_launches(cuda):
    """One launch of csrc/scan.cu over five pieces of 47, 71 and 83 states
    and mixed lengths, hinted and not: every piece's values, backpointers and
    final column bit-equal to its own launch."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    from torch_nc_check import nc_run
    args, fasta = nc_run("nc_hints")
    nc = piece_scan(Model.load(args), read_fasta(fasta)[0], 5000, cuda)[:3]
    pieces = [_utr_scan("HS04636.fa", 6000, None, cuda),
              _utr_scan("HS04636.fa", None, None, cuda),
              _utr_scan("HS04636sm.fa", None, "HS04636sm.E.gff", cuda),
              _utr_scan("HS04636.fa", 3000, None, cuda, "repo_fixture"), nc]
    assert sorted({st.S for st, _, _ in pieces}) == [47, 71, 83]
    single = [S.scan_forward(st, t, v0, debug_vals=True)
              for st, t, v0 in pieces]
    before = S.scan_forward.batched_launches
    batch = S.scan_forward_batch(pieces, debug_vals=True)
    torch.cuda.synchronize()
    assert S.scan_forward.batched_launches == before + 1
    for one, got in zip(single, batch):
        for a, b in zip(one, got):
            assert _bit_equal(a, b)


@pytest.mark.cuda
def test_batched_event_walk_exact_at_every_width(cuda):
    """csrc/trace.cu over the planes of K1 (64 wide) and of K2 (71 and 83
    wide) in one batched launch, with a bound that makes some walks
    relaunch: every walk's events, final base and count equal to its single
    walk on the card and to the plain version on the CPU."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    from torch_nc_check import nc_run
    st, planes = _planes("repo_fixture", None, cuda)
    bp, vf, _ = viterbi_forward(st, planes)
    planes_k = [(bp, vf[: st.S], st.n)]
    args, fasta = nc_run("nc_hints")
    for sst, t, v0 in [_utr_scan("HS04636.fa", None, None, cuda),
                       piece_scan(Model.load(args), read_fasta(fasta)[0],
                                  None, cuda)[:3]]:
        planes_k.append(S.scan_forward(sst, t, v0)[:2] + (sst.n,))
    assert [bp.shape[1] for bp, _, _ in planes_k] == [64, 71, 83]
    walks = [(bp, torch.argmax(vf).reshape(1), n) for bp, vf, n in planes_k]
    for M in (tb.M_EVENTS, 9):
        before = tb.event_walk.batched_launches
        got = tb.event_walk_batch(walks, M)
        assert tb.event_walk.batched_launches > before
        assert max(cnt for _, _, cnt in got) > 9
        for (bp, s, n), (ev, fb, cnt) in zip(walks, got):
            one = tb.event_walk(bp, int(s), n, M)
            plain = tb.event_walk(bp.cpu(), int(s), n, M)
            for want in (one, plain):
                assert (fb, cnt) == want[1:] and np.array_equal(ev, want[0])

