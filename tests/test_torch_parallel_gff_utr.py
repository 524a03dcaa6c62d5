"""The GFF of a UTR sequence cut into pieces that prints a gene: bases
501-3,500 of HS04636.fa softmasked with its EST hints, --UTR=on
--print_utr=on, --maxDNAPieceSize=1500 (two pieces through K2): the port's
predict_sequence on the CPU with --pieceParallel true (in flight) and
false (one piece after another) equal to augustus_tpu's text, which its
predict_sequence gives on tier-1's 8 virtual CPU devices (its mesh's
decode_pieces) and tests/torch_goldens.py commits as
repo_fixture_utr_HS04636sm_hints_pieces1500.gff; a test marked slow
recomputes it with augustus_tpu (about 2 minutes)."""

import os

import pytest
import torch

from augustus_tpu_torch.parallel import mesh
from augustus_tpu_torch.predict import Model, predict_file

from torch_goldens import GOLDEN_DIR, GOLDENS, golden_gff, utr_run

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
WHICH = "utr_pieces_hints"


def _golden() -> str:
    with open(os.path.join(GOLDEN_DIR, GOLDENS[WHICH])) as fh:
        return fh.read()


@pytest.mark.parametrize("flag", ["true", "false"])
def test_gff_equal_to_reference_golden(flag):
    args, fasta = utr_run(WHICH)
    mesh.decode_pieces.last = None
    got = predict_file(Model.load(dict(args, pieceParallel=flag)), fasta,
                       device="cpu")
    assert (mesh.decode_pieces.last is not None) == (flag == "true")
    assert got == _golden()
    assert got.count("\tgene\t") >= 1 and "\t5'-UTR\t" in got


@pytest.mark.slow
def test_golden_equal_to_reference():
    assert golden_gff(WHICH) == _golden()
