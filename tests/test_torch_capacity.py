"""Pieces past a kernel's capacity on the CPU: the route is chosen by
capacity before any launch (viterbi.k1_fits, forward.k3_fits,
predict._engine), and the pieces that augustus_tpu sends from its Pallas
kernel to its scan decode through the general kernels K2 / K5 (their
plain versions here) with augustus_tpu's GFF byte for byte.

Inputs: tests/torch_capacity_fixtures.py (exonpart hints of unjoined
RNA-seq reads stacked past K1's 64 crossing slots, and deeper, past what
K2 holds in shared memory) and the species repo_fixture_wide
(augustus_tpu_torch/data/make_wide_intron_fixture.py, a lessD window of
79 bases, past K3's 64)."""

import dataclasses
import os

import pytest
import torch

from augustus_tpu_torch import stats
from augustus_tpu_torch.engine import scan as S
from augustus_tpu_torch.engine import viterbi as V
from augustus_tpu_torch.engine.forward import (LESSD_MAXW, k3_fits,
                                               kernel_limits)
from augustus_tpu_torch.engine.pack import pack_tracks
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, piece_scan, predict_file
from torch_capacity_fixtures import (DEPTHS, capacity_reads, capacity_run,
                                     max_depth)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
torch.set_num_threads(1)
OLD_HEADER = 48         # the descriptor header's ints before the deep layout


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN, name)) as fh:
        return fh.read()


def _packed(args, fasta, n=None):
    """(pack_tracks' (static, arrays) or None for more than 64 states,
    split_tracks' ScanStatic, tables, v0) of the first n bases on the host
    route."""
    m = Model.load(dict(args))
    rec = read_fasta(fasta)[0]
    st, t, v0, gold = piece_scan(m, rec, n, "cpu")
    from augustus_tpu_torch.engine.device import build_tracks
    packed = pack_tracks(build_tracks(gold)) if st.S <= 64 else None
    return packed, st, t, v0


def test_depths_of_the_inputs():
    """The reads stack exactly as deep as DEPTHS says (each covers the
    exon's middle)."""
    for which, reads in DEPTHS.items():
        assert max_depth(capacity_reads(reads)) == reads


def test_slots_piece_takes_k2_with_the_golden(tmp_path):
    """70 crossing slots: K1 cannot hold the piece, so the host route runs
    K2 (its plain version here), and the GFF, evidence blocks included,
    equals augustus_tpu's (the committed golden; the live comparison is
    test_slots_golden_equal_to_reference)."""
    args, fasta = capacity_run("slots", str(tmp_path))
    (pst, parr), st, _, _ = _packed(args, fasta)
    assert not V.k1_fits(pst, parr)
    assert "hint slots" in V.k1_refusal(pst, *V.packed_widths(parr))
    stats.reset()
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    assert stats.COUNTS.get("k1_capacity_to_k2") == 1
    assert "device_prep" not in stats.COUNTS
    assert got == _golden("repo_fixture_capacity_slots.gff")
    assert "# Evidence for and against" in got


@pytest.mark.slow
def test_slots_golden_equal_to_reference(tmp_path):
    """augustus_tpu's predict_file (its scan on the CPU, about 3.5 minutes)
    gives the committed golden."""
    from augustus_tpu.predict import Model as JModel, predict_file as jpf
    args, fasta = capacity_run("slots", str(tmp_path))
    assert jpf(JModel.load(dict(args)), fasta, engine="scan") == \
        _golden("repo_fixture_capacity_slots.gff")


def _with_slots(pst, k: int):
    """The static with its first hinted conv holding k crossing slots."""
    i = next(i for i, cv in enumerate(pst.convs) if cv.hint is not None)
    h = pst.convs[i].hint
    slots = (tuple(h.cross) * k)[:k]
    cv = dataclasses.replace(pst.convs[i], hint=dataclasses.replace(
        h, cross=slots))
    return dataclasses.replace(pst, convs=pst.convs[:i] + (cv,) +
                               pst.convs[i + 1:])


@pytest.mark.parametrize("k,fits", [(V.MAX_SLOTS, True),
                                    (V.MAX_SLOTS + 1, False)])
def test_k1_fits_agrees_with_the_wrapper_at_the_slot_edge(tmp_path, k, fits):
    """k1_fits at 64 and 65 crossing slots of one conv (the other convs
    of the HS04636sm hint fixture's piece unchanged) says what the
    wrapper's descriptor does: taken at 64, refused at 65."""
    args = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "1",
            "hintsfile": os.path.join(ROOT, "augustus_tpu_torch", "data",
                                      "hints", "HS04636sm.E.gff"),
            "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}
    (pst, parr), _, _, _ = _packed(
        args, os.path.join(ROOT, "tests", "data", "HS04636sm.fa"), 2000)
    assert pst.NHW and V.k1_fits(pst, parr)
    edge = _with_slots(pst, k)
    assert V.k1_fits(edge, parr) == fits
    sel, nxh, nxi = V.packed_widths(parr)
    if fits:
        V._descriptor(edge, sel, nxh, nxi)
    else:
        with pytest.raises(NotImplementedError, match="hint slots"):
            V._descriptor(edge, sel, nxh, nxi)


@pytest.mark.parametrize("window,fits", [(LESSD_MAXW, True),
                                         (LESSD_MAXW + 1, False)])
def test_k3_fits_agrees_with_kernel_limits_at_the_window_edge(window, fits):
    """k3_fits at lessD windows of 64 and 65 says what K3's wrapper
    (kernel_limits) does."""
    args = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}
    (pst, parr), _, _, _ = _packed(
        args, os.path.join(ROOT, "tests", "data", "HS04636.fa"), 1500)
    wide = dataclasses.replace(pst, lessd=[dataclasses.replace(
        pst.lessd[0], window=window)] + list(pst.lessd[1:]))
    assert k3_fits(wide, parr) == fits
    if fits:
        kernel_limits(wide)
    else:
        with pytest.raises(NotImplementedError, match="lessD window"):
            kernel_limits(wide)


def _old_desc_len(st, desc) -> int:
    """The descriptor's length in the layout before the slot lists moved
    to its tail: every hinted conv's record held its slots inline (3 ints
    each) and not the three fields that follow its counts now (the lists'
    offset, its own offset, its conv's a_off), and the header had
    OLD_HEADER ints."""
    hinted = [cv.hint for cv in st.convs if cv.hint is not None]
    tail = int(desc.size) - int(desc[S.D_SHARE_AT]) if desc[S.D_DEEP_AT] \
        else sum(3 * len(k) for k in {tuple(h.cross_cols) + tuple(
            h.ex_cols) for h in hinted})
    return int(desc.size) - tail - 3 * len(hinted) + sum(
        3 * (len(h.cross_cols) + len(h.ex_cols)) for h in hinted) - (
            S.D_HEADER - OLD_HEADER)


@pytest.mark.parametrize("reads,old_past,deep", [
    (361, False, False), (362, True, False), (1115, True, False),
    (1116, True, True)])
def test_k2_descriptor_on_each_side_of_its_limits(tmp_path, reads, old_past,
                                                  deep):
    """On the 47-state piece, 361 and 362 crossing slots end the old
    layout's descriptor (slots inline in every hinted conv's record) either
    side of its 12,288 ints; the descriptor that K2 takes now keeps one
    slot list per distinct list and holds both in shared memory.  1,115
    slots are the most whose staged rows and descriptor fit a batched
    launch's block (232,448 bytes less its 256-byte record); at 1,116 the
    deep layout takes the piece.  The
    wrapper's checks pass on the CPU as on the card; only the deep piece
    needs K2's EXT instantiation."""
    args, fasta = capacity_run("deep", str(tmp_path))
    with open(args["hintsfile"]) as fh:
        lines = fh.readlines()
    with open(args["hintsfile"], "w") as fh:
        fh.writelines(lines[:reads])
    assert max_depth(capacity_reads(DEPTHS["deep"])[:reads]) == reads
    _, st, t, v0 = _packed(args, fasta)
    desc, _ = S._check(st, t, v0)[1]
    assert (_old_desc_len(st, desc) > S.MAX_DESC) == old_past
    assert desc[S.D_DEEP_AT] == int(deep)
    assert desc[S.D_SHARE_AT] <= S.MAX_DESC
    assert desc[S.D_BYTES_AT] <= S.SMEM_BYTES - S.BATCH_RECORD_BYTES
    assert S.needs_ext(st, desc) == int(deep)
    if not deep:
        assert desc[S.D_SHARE_AT] == desc.size


@pytest.mark.parametrize("species", ["repo_fixture", "repo_fixture_utr"])
def test_deep_piece_takes_the_deep_layout(tmp_path, species):
    """1,300 crossing slots pass what K2's shared memory holds for 47 and
    71 states: the descriptor takes the deep layout (slot lists past the
    shared part, staged rows without the slot columns), whose shared part
    and bytes do not grow with the depth, and the kernel's tables are
    split_tracks' own with their columns in deep_perms' order."""
    args, fasta = capacity_run("deep", str(tmp_path), species)
    _, st, t, v0 = _packed(args, fasta)
    desc, _ = S._check(st, t, v0)[1]
    assert desc[S.D_DEEP_AT] == 1
    assert desc[S.D_SHARE_AT] <= S.MAX_DESC
    assert desc[S.D_BYTES_AT] <= S.SMEM_BYTES
    ss, si = S.slot_columns(st)
    assert desc[S.D_NSS_AT] == st.NSC - len(ss) and \
        desc[S.D_NIS_AT] == st.NIC - len(si)
    stab, itab = S.kernel_tables(st, t, desc)
    ps, pi = S.deep_perms(st)
    assert sorted(ps) == list(range(st.NSC)) and \
        sorted(pi) == list(range(st.NIC))
    assert torch.equal(stab, t["scalar_table"][:, ps])
    assert torch.equal(itab, t["int_table"][:, pi])
    # the slot lists lie past the shared part, every one within the tail
    assert desc.size - desc[S.D_SHARE_AT] == sum(
        3 * len(k) for k in {tuple(cv.hint.cross_cols) + tuple(
            cv.hint.ex_cols) for cv in st.convs if cv.hint is not None})


def test_mixed_batch_of_k1_and_k2_pieces(tmp_path):
    """parallel/mesh.decode_pieces chooses each piece's kernel through
    predict._engine: a piece that K1 holds and the capacity piece, which
    it does not, decode in one batch with one K1 and one K2 block, each
    path equal to the sequential decode's."""
    from augustus_tpu_torch.parallel import mesh
    from augustus_tpu_torch.predict import _decode, _new_gold, _piece_input
    args, fasta = capacity_run("slots", str(tmp_path))
    m = Model.load(dict(args))
    rec = read_fasta(fasta)[0]
    pieces = []
    for n in (700, None):
        codes, softmask, hints = _piece_input(m, rec, n)
        if n is not None:
            hints = [f for f in hints if f.end < 600]
        pieces.append({"codes": codes, "softmask": softmask,
                       "gff_hints": hints, "init_synch": False,
                       "term_synch": False})
    stats.reset()
    got = mesh.decode_pieces(m, pieces, "cpu")
    assert stats.COUNTS.get("k1_capacity_to_k2") == 1
    kernels = set(mesh.decode_pieces.last["bytes_per_base"])
    assert "scan_forward" in kernels and len(kernels) == 2
    for pi, (path, _) in zip(pieces, got):
        gold = _new_gold(m, False, False)
        want = _decode(gold, pi["codes"], pi["softmask"], pi["gff_hints"],
                       torch.device("cpu"))
        assert [(p.type, p.begin, p.end) for p in path] == \
            [(p.type, p.begin, p.end) for p in want]
