"""MEA with UTR models on the CPU (--UTR=on --print_utr=on --mea=1
--/CompPred/logreg=false, the piecewise-linear scores), the port against
augustus_tpu: the GFF of tests/data/HS04636.fa (K2's and K5's plain
versions, 100 sampled paths, output/mea.py with its UTR branches)
byte-equal without '#' lines to the committed golden, augustus_tpu's
text; marked slow, the golden recomputed with augustus_tpu."""

import os

import pytest
import torch

from augustus_tpu_torch.engine.scan import scan_table
from augustus_tpu_torch.predict import Model, predict_file
from torch_goldens import (GOLDEN_DIR, GOLDENS, body, utr_reference,
                           utr_run)

# the plain versions run a Python loop of small torch ops
torch.set_num_threads(1)


def golden() -> str:
    with open(os.path.join(GOLDEN_DIR, GOLDENS["utr_mea"])) as fh:
        return fh.read()


def test_utr_mea_gff_equal_to_golden():
    args, fasta = utr_run("utr_mea")
    before = scan_table.launches
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    assert scan_table.launches == before          # plain version on the CPU
    assert body(got) == body(golden())
    assert got.count("\tgene\t") >= 1 and "\ttss\t" in got


@pytest.mark.slow
def test_utr_mea_golden_equal_to_reference():
    assert body(golden()) == body(utr_reference("utr_mea"))
