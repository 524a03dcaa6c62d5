"""Pieces in flight on the CPU (augustus_tpu_torch/parallel/mesh.py): the
port's decode_pieces against augustus_tpu's parallel.mesh.decode_pieces
(sharded over tier-1's 8 virtual CPU devices) on the four pieces of
HS04636.fa at --maxDNAPieceSize=3000, the 47-state repo_fixture; against
the port's own sequential decode; cut into batches by the memory budget;
and the batched event walk against the walk of each plane."""

import os

import numpy as np
import pytest
import torch

from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.parallel import mesh
from augustus_tpu_torch.predict import Model, _decode, _new_gold

from torch_pieces import CONFIG, DATA, key, piece_inputs, reference_paths

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}
FASTA = os.path.join(DATA, "HS04636.fa")


@pytest.fixture(scope="module")
def decoded():
    model = Model.load(dict(ARGS))
    pieces = piece_inputs("augustus_tpu_torch", model, FASTA)
    return model, pieces, mesh.decode_pieces(model, pieces, "cpu"), \
        dict(mesh.decode_pieces.last)


def test_four_pieces_of_mixed_lengths(decoded):
    _, pieces, got, record = decoded
    assert [p["codes"].shape[0] for p in pieces] == [3000, 3000, 3000, 453]
    assert len(got) == 4 and record["batches"] == 1
    assert record["ctas"] == [{"kernel": "viterbi_forward", "blocks": 4},
                              {"kernel": "event_walk", "blocks": 4}]
    assert record["bytes_per_base"]["viterbi_forward"] > 0


def test_segments_equal_to_reference(decoded):
    model, _, got, _ = decoded
    jmodel = JModel.load(dict(ARGS))
    want = reference_paths(jmodel, piece_inputs("augustus_tpu", jmodel,
                                                FASTA))
    assert [key(path) for path, _ in got] == want
    assert sum(len(w) for w in want) > 4


def test_segments_equal_to_the_sequential_decode(decoded):
    model, pieces, got, _ = decoded
    for pi, (path, gold) in zip(pieces, got):
        seq_gold = _new_gold(model, pi["init_synch"], pi["term_synch"])
        want = _decode(seq_gold, pi["codes"], pi["softmask"],
                       pi["gff_hints"], torch.device("cpu"), model.route)
        assert key(path) == key(want)
        assert gold.n == pi["codes"].shape[0] and not gold.has_hints


def test_memory_budget_cuts_batches(decoded, monkeypatch):
    """With a budget below any piece's bytes every piece is a batch of its
    own, and the paths do not change."""
    model, pieces, got, _ = decoded
    monkeypatch.setattr(mesh, "memory_budget", lambda device: 1)
    again = mesh.decode_pieces(model, pieces[:3], "cpu")
    assert mesh.decode_pieces.last["batches"] == 3
    assert [key(p) for p, _ in again] == [key(p) for p, _ in got[:3]]


def test_piece_that_no_kernel_takes_raises(decoded):
    """No fallback: a piece beyond the kernels' limits raises, as on the
    sequential path (here: a piece that neither K1 nor K2 can lay out in
    shared memory; a piece K1 alone refuses goes to K2)."""
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.engine import viterbi as V
    model, pieces, _, _ = decoded
    limit, limit2 = V.SMEM_LIMIT, S.SMEM_BYTES
    try:
        V.SMEM_LIMIT = 1024
        S.SMEM_BYTES = 1024
        with pytest.raises(NotImplementedError):
            mesh.decode_pieces(model, pieces[:2], "cpu")
    finally:
        V.SMEM_LIMIT, S.SMEM_BYTES = limit, limit2


def test_batched_walk_equals_the_walk_of_each_plane():
    """event_walk_batch over planes of widths 47, 64, 71 and 83 (random
    planes with chain-state runs), with a bound that makes walks relaunch,
    equals event_walk on each."""
    from augustus_tpu_torch.engine import traceback as tb
    rng = np.random.default_rng(11)
    walks = []
    for n, W in ((700, 47), (1500, 64), (900, 71), (1200, 83)):
        off = np.minimum(rng.integers(1, 30, size=(n, W)),
                         np.arange(n)[:, None].clip(min=1))
        pred = rng.integers(0, W, size=(n, W))
        selfloop = rng.random((n, W)) < 0.9
        lanes = np.broadcast_to(np.arange(W), (n, W))
        bp = ((np.where(selfloop, lanes, pred) << 20)
              | np.where(selfloop, 1, off)).astype(np.int32)
        bp[0] = 0
        walks.append((torch.from_numpy(bp), int(rng.integers(0, W)), n))
    for M in (tb.M_EVENTS, 13):
        got = tb.event_walk_batch(walks, M)
        for (bp, s, n), (ev, fb, cnt) in zip(walks, got):
            ev1, fb1, cnt1 = tb.event_walk(bp, s, n, M)
            assert cnt > 13 and (fb, cnt) == (fb1, cnt1)
            assert np.array_equal(ev, ev1)
