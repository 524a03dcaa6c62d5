"""Pieces in flight on the CPU through K2: the port's decode_pieces on the
four pieces of 1,500 bases of the first 6,000 of the softmasked
HS04636sm.fa with its EST hints, the 71-state repo_fixture_utr (--UTR=on;
hinted pieces take the host route and K2 with its hint quotient), against
augustus_tpu's parallel.mesh.decode_pieces of the same pieces (its scan
engine sharded over tier-1's 8 virtual CPU devices), whose condensed
paths tests/torch_goldens.py commits as
repo_fixture_utr_HS04636sm_hints_pieces1500.json: its JAX scan takes about
2 minutes on a CPU, so a test marked slow recomputes them."""

import json
import os

import pytest
import torch

from augustus_tpu_torch.parallel import mesh
from augustus_tpu_torch.predict import Model

from torch_goldens import GOLDEN_DIR, GOLDENS, golden_gff
from torch_pieces import CONFIG, DATA, HINTS, key, piece_inputs

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
ARGS = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "on", "softmasking": "1", "print_utr": "on",
        "hintsfile": os.path.join(HINTS, "HS04636sm.E.gff"),
        "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}
FASTA = os.path.join(DATA, "HS04636sm.fa")
WHICH = "utr_pieces_segments"


def _golden() -> str:
    with open(os.path.join(GOLDEN_DIR, GOLDENS[WHICH])) as fh:
        return fh.read()


def test_segments_equal_to_reference():
    from augustus_tpu_torch import stats
    model = Model.load(dict(ARGS))
    pieces = piece_inputs("augustus_tpu_torch", model, FASTA, 1500, 6000)
    stats.reset(True)
    try:
        got = mesh.decode_pieces(model, pieces, "cpu")
        counts = dict(stats.COUNTS)
    finally:
        stats.reset(False)
    assert counts == {"host_prep": 4}
    assert mesh.decode_pieces.last["ctas"][0] == {"kernel": "scan_forward",
                                                  "blocks": 4}
    want = json.loads(_golden())
    assert [[list(s) for s in key(path)] for path, _ in got] == want
    assert sum(map(len, want)) > 4 and all(g.has_hints for _, g in got)


@pytest.mark.slow
def test_golden_equal_to_reference():
    assert golden_gff(WHICH) == _golden()
