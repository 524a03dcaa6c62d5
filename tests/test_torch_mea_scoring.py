"""MEA (--mea=1) with --/CompPred/logreg=false on the CPU, the port against
augustus_tpu: node and edge scores from the piecewise-linear transform of
the posteriors (/MeaPrediction/*) and the float32 base-level averages, on
tests/data/HS04636.fa; the GFF byte-equal without '#' lines and the
committed golden kept equal to it."""

import os

import pytest
import torch

from augustus_tpu_torch.engine.forward import forward_table
from torch_goldens import GOLDEN_DIR, GOLDENS, body, golden_gff, \
    reference_gff

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return reference_gff("mea_nologreg")


def test_mea_nologreg_gff_equal_to_reference(reference):
    before = forward_table.launches
    got = golden_gff("mea_nologreg")
    assert forward_table.launches == before     # plain version on the CPU
    assert body(got) == body(reference)
    assert got.count("\tgene\t") >= 1


def test_mea_nologreg_golden_equal_to_reference(reference):
    with open(os.path.join(GOLDEN_DIR, GOLDENS["mea_nologreg"])) as fh:
        assert body(fh.read()) == body(reference)
