"""The GFFs of HS08198.fa with the nc hint files of several starts per
intron end (tests/torch_nc_check.py:write_multi_hints) from the port's
CPU path, byte-equal to their committed goldens (the port's text, whose
tables tests/test_torch_nc.py and test_torch_nc_multi.py hold to
augustus_tpu's GoldEngine.run; augustus_tpu prints no noncoding
transcript)."""

import os

import pytest
import torch

import torch_nc_check
from augustus_tpu_torch.predict import Model, predict_file
from torch_goldens import GOLDEN_DIR, GOLDENS

torch.set_num_threads(1)


@pytest.mark.parametrize("which", torch_nc_check.MULTI)
def test_multi_gff_equal_to_golden(tmp_path, which):
    args, fasta = torch_nc_check.nc_run(which, str(tmp_path))
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        assert got == fh.read()
    assert "\tncRNA\t" in got or "noncoding" in got
