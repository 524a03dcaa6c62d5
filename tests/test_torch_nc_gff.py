"""The GFF of HS04636.fa with tests/data/nc_hints.gff and --nc=on from the
port's CPU path: byte-equal to its committed golden (the port's text:
augustus_tpu's projection never leaves a path with a noncoding
transcript, tests/torch_goldens.py), and its noncoding transcript
printed as AUGUSTUS 3.5.0 prints the same transcript
(tests/data/golden_human_nc_hints_HS04636.gff, the reference binary's
run of the same hints with its human species); the command line takes
--nc=on.  Tests marked slow recompute the port's nc goldens."""

import os
import re
import subprocess
import sys

import pytest
import torch

from augustus_tpu_torch.predict import Model, predict_file
from torch_goldens import GOLDEN_DIR, GOLDENS, body, golden_gff
from torch_nc_check import DATA, ROOT, nc_run

torch.set_num_threads(1)


def _golden(which):
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        return fh.read()


def _nc_blocks(text):
    """The lines of each noncoding gene, its gene id written as 'g'."""
    blocks, cur = [], None
    for line in text.splitlines():
        if line.startswith("# start gene"):
            cur = []
        elif line.startswith("# end gene"):
            if cur and any("\tnoncoding_transcript\t" in l for l in cur):
                blocks.append(cur)
            cur = None
        elif cur is not None and not line.startswith("#"):
            cur.append(re.sub(r"\bg\d+\b", "g", line))
    return blocks


def test_gff_equal_to_golden():
    args, fasta = nc_run("nc_hints")
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    assert body(got) == body(_golden("nc_hints"))


def test_noncoding_transcript_as_the_reference_prints_it():
    want = _nc_blocks(open(os.path.join(
        DATA, "golden_human_nc_hints_HS04636.gff")).read())
    got = _nc_blocks(_golden("nc_hints"))
    assert len(want) == 1 and got == want


def test_command_line_takes_nc():
    args, fasta = nc_run("nc_plain")
    cmd = [sys.executable, "-m", "augustus_tpu_torch.cli.augustus"] + [
        f"--{k}={v}" for k, v in args.items()] + ["--device=cpu", fasta]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert body(r.stdout) == body(_golden("nc_plain"))


@pytest.mark.slow
@pytest.mark.parametrize("which", ["nc_hints", "nc_fixture"])
def test_port_goldens_recomputed(which):
    assert body(golden_gff(which)) == body(_golden(which))
