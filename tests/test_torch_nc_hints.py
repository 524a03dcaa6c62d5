"""The ncRNA decode (--nc=on) of HS08198.fa, without hints and with the
hint fixture HS08198.nc.gff (augustus_tpu_torch/data/make_nc_fixture.py:
intron hints that make ncintronvar and rncintronvar fire, dss and ass
hints on both strands, exonparts, a reverse-strand transcript), in the
port against augustus_tpu on the CPU: values, backpointers and decoded
segments as tests/test_torch_nc_decode.py holds them, and the GFF
byte-equal to its committed golden: augustus_tpu's text without hints,
the port's with them (augustus_tpu prints no text for a path with a
noncoding transcript; tests/torch_goldens.py says why)."""

import os

import pytest
import torch

from augustus_tpu.output.genes import condense_path
from augustus_tpu_torch.model.state_config import is_nc
from augustus_tpu_torch.predict import Model, predict_file
from torch_goldens import GOLDEN_DIR, GOLDENS, body, golden_gff
from torch_nc_check import TOL, compare, gold_engine, nc_run, port_scan

torch.set_num_threads(1)


def _golden(which):
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        return fh.read()


@pytest.mark.parametrize("which", ["nc_plain", "nc_fixture"])
def test_decode_equal_to_gold(which):
    gold = gold_engine(which)
    _, tr, eng = port_scan(which)
    nc = [s for s, t in enumerate(gold.sg.state_types) if is_nc(t)]
    worst, live, checked, ties = compare(gold, tr, eng, TOL, nc)
    assert worst <= TOL and live > 10_000
    want = condense_path(gold.traceback(), gold.n)
    got = eng.traceback_path(gold.n)
    assert [(p.begin, p.end, int(p.type)) for p in got] == \
        [(p.begin, p.end, int(p.type)) for p in want]
    if which == "nc_fixture":
        assert checked > 1000 and len(ties) < checked
        strands = {"+" if t < 80 else "-" for t in
                   (int(p.type) for p in got if is_nc(p.type))}
        assert strands == {"+", "-"}


@pytest.mark.parametrize("which", ["nc_plain", "nc_fixture"])
def test_gff_equal_to_golden(which):
    """The port's CPU path prints the golden; with the hint fixture a
    noncoding transcript on each strand."""
    args, fasta = nc_run(which)
    got = predict_file(Model.load(dict(args)), fasta, device="cpu")
    golden = _golden(which)
    assert body(got) == body(golden)
    nc = [l.split("\t") for l in body(golden).splitlines()
          if "\tnoncoding_transcript\t" in l]
    if which == "nc_fixture":
        assert sorted(f[6] for f in nc) == ["+", "-"]
    else:
        assert not nc and "\ttranscript\t" in golden


def test_plain_golden_equal_to_reference_text():
    """Without hints no nc transcript is decoded, so augustus_tpu prints
    the text: the golden is it."""
    assert body(golden_gff("nc_plain")) == body(_golden("nc_plain"))
