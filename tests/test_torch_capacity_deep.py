"""The deep capacity input (tests/torch_capacity_fixtures.py: 1,300
exonpart hints stacked over one exon, past what K2 holds in shared memory)
on the CPU: K1 cannot hold it, so it decodes through K2 (its plain version
here; on the card the deep layout of engine/scan.py:_descriptor), and the
GFF equals the committed golden, the port's own CPU path (augustus_tpu's
CPU scan took 203 s at 70 slots and grows with the depth;
tests/test_torch_capacity.py holds the 70-slot input to augustus_tpu
itself).  The 71-state run is in
test_torch_capacity_deep_utr.py."""

import os

import torch

from augustus_tpu_torch import stats
from augustus_tpu_torch.predict import Model, predict_file
from torch_capacity_fixtures import capacity_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
torch.set_num_threads(1)


def deep_gff_equal_to_golden(tmp_path, species: str, golden: str) -> None:
    args, fasta = capacity_run("deep", str(tmp_path), species)
    stats.reset()
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    assert stats.COUNTS.get("host_prep") == 1
    if species == "repo_fixture":
        assert stats.COUNTS.get("k1_capacity_to_k2") == 1
    with open(os.path.join(GOLDEN, golden)) as fh:
        assert got == fh.read()
    assert got.count("\tgene\t") >= 1


def test_deep_piece_gff_equal_to_golden(tmp_path):
    deep_gff_equal_to_golden(tmp_path, "repo_fixture",
                             "repo_fixture_capacity_deep.gff")
