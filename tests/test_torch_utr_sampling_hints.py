"""UTR sampling with softmasking and EST hints on the CPU, the port against
augustus_tpu: tests/data/HS04636sm.fa with HS04636sm.E.gff and
extrinsic.M.RM.E.W.cfg, --UTR=on --sample=100
--alternatives-from-sampling=true and the posterior filters (the hint
quotient in K2's and K5's plain versions, the hint terms of the walk's
candidates): the GFF byte-equal without '#' lines to the committed golden,
augustus_tpu's text, evidence blocks included; marked slow, the golden
recomputed with augustus_tpu."""

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
    with open(os.path.join(GOLDEN_DIR, GOLDENS["utr_sample_hints"])) as fh:
        return fh.read()


def test_utr_hinted_sampled_gff_equal_to_golden():
    args, fasta = utr_run("utr_sample_hints")
    before = scan_table.launches
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    assert scan_table.launches == before          # plain version on the CPU
    assert body(got) == body(golden())
    assert "# Evidence for and against" in got
    assert got.count("\ttranscript\t") >= 2


@pytest.mark.slow
def test_utr_hinted_sample_golden_equal_to_reference():
    assert body(golden()) == body(utr_reference("utr_sample_hints"))
