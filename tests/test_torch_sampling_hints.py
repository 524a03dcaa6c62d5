"""Sampling with softmasking and EST hints on the CPU, the port against
augustus_tpu: tests/data/HS04636sm.fa with HS04636sm.E.gff and
extrinsic.M.RM.E.W.cfg (the configuration of bench.py), --sample=100
--alternatives-from-sampling=true and the posterior filters
--minexonintronprob, --minmeanexonintronprob and --keep_viterbi: the GFF
byte-equal, evidence blocks included, and the committed golden kept equal
to it.  The forward table of this piece runs the hint quotient and the
walk the hint terms of every candidate builder."""

import os

import pytest
import torch

from augustus_tpu.predict import Model as JModel, predict_file as jpredict
from augustus_tpu_torch.predict import Model, predict_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
PKG_DATA = os.path.join(ROOT, "augustus_tpu_torch", "data")
FASTA = os.path.join(ROOT, "tests", "data", "HS04636sm.fa")
GOLDEN = os.path.join(PKG_DATA, "golden",
                      "repo_fixture_HS04636sm_hints_sample100.gff")
ARGS = {"species": "repo_fixture",
        "AUGUSTUS_CONFIG_PATH": os.path.join(PKG_DATA, "config"),
        "UTR": "off", "softmasking": "1",
        "hintsfile": os.path.join(PKG_DATA, "hints", "HS04636sm.E.gff"),
        "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg", "sample": "100",
        "alternatives-from-sampling": "true", "minexonintronprob": "0.08",
        "minmeanexonintronprob": "0.4", "keep_viterbi": "true"}


@pytest.fixture(scope="module")
def reference():
    return jpredict(JModel.load(dict(ARGS)), FASTA, engine="scan")


def test_hinted_sampled_gff_equal_to_reference(reference):
    got = predict_file(Model.load(dict(ARGS)), FASTA, device="cpu")
    assert got == reference
    assert "# Evidence for and against" in got
    assert got.count("\ttranscript\t") >= 2


def test_hinted_sample_golden_equal_to_reference(reference):
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert golden == reference
