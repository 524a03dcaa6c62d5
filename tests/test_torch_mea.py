"""MEA (--mea=1) on the CPU, the port against augustus_tpu: the GFF of
tests/data/HS04636.fa byte-equal without '#' lines and its committed golden
kept equal to it, with the default scoring (/CompPred/logreg on with zero
weights, so every node and edge scores 0 and the tie order alone picks the
path); get_mea_transcripts of both packages on the same transcripts in
three scoring modes; in a test marked slow, the golden of chip_smoke.py's
mea_depth piece.  tests/test_torch_mea_scoring.py and
tests/test_torch_mea_hints.py hold the other two MEA goldens."""

import copy
import dataclasses
import os

import pytest
import torch

from augustus_tpu.model.state_config import ST as JST
from augustus_tpu.output import genes as jog
from augustus_tpu.output.mea import get_mea_transcripts as jmea
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch import predict
from augustus_tpu_torch.engine.forward import forward_table
from augustus_tpu_torch.output.mea import get_mea_transcripts
from augustus_tpu_torch.predict import Model
from torch_goldens import GOLDEN_DIR, GOLDENS, MEA, NOLOGREG, body, \
    golden_gff, reference_gff

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
# the scoring modes of get_mea_transcripts: the default (logistic
# regression with zero weights), logistic regression with weights, and the
# piecewise-linear transform of the posteriors
SCORING = {"logreg": MEA,
           "logreg_weights": dict(MEA, **{
               "lg_exon_score0": "-0.5", "lg_exon_score1": "2.0",
               "lg_exon_score2": "1.5", "lg_exon_score3": "0.1",
               "/CompPred/intron_score0": "-0.25",
               "/CompPred/intron_score1": "1.0",
               "/CompPred/intron_score2": "0.5",
               "/CompPred/intron_score3": "-0.05"}),
           "piecewise": NOLOGREG}


@pytest.fixture(scope="module")
def port_run():
    """The port's GFF of the mea golden's input on the CPU, the forward
    kernel's launches meanwhile, and each (transcripts, codes) that the run
    gave get_mea_transcripts."""
    seen = []

    def record(genes, codes, props, gcode):
        seen.append((copy.deepcopy(genes), codes.copy()))
        return get_mea_transcripts(genes, codes, props, gcode)
    before = forward_table.launches
    predict.get_mea_transcripts = record
    try:
        text = golden_gff("mea")
    finally:
        predict.get_mea_transcripts = get_mea_transcripts
    return text, forward_table.launches - before, seen


@pytest.fixture(scope="module")
def reference():
    return reference_gff("mea")


def test_mea_gff_equal_to_reference(port_run, reference):
    text, launches, seen = port_run
    assert launches == 0                    # the plain version on the CPU
    assert body(text) == body(reference)
    # with zero scores the longest path found first is the neutral line
    # on this piece: no gene, in both packages
    assert "# (none)" in text and len(seen) == 1 and len(seen[0][0]) > 10


def test_mea_golden_equal_to_reference(reference):
    with open(os.path.join(GOLDEN_DIR, GOLDENS["mea"])) as fh:
        assert body(fh.read()) == body(reference)


def _to_reference(g):
    """A port Gene as an augustus_tpu Gene with the same fields."""
    out = jog.Gene()
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, list):
            v = [jog.PathState(**dict(dataclasses.asdict(s),
                                      type=JST(int(s.type)))) for s in v]
        setattr(out, f.name, v)
    return out


def _chosen(genes):
    return [(g.strand, g.complete, g.codingstart, g.codingend,
             [(s.begin, s.end, int(s.type)) for s in g.exons],
             [(s.begin, s.end, int(s.type)) for s in g.introns])
            for g in genes]


@pytest.mark.parametrize("scoring", sorted(SCORING))
def test_get_mea_transcripts_alone(port_run, scoring):
    """Both packages' get_mea_transcripts on the sampled, filtered
    transcripts of the run above: the same chosen transcripts, states and
    types; the weighted and piecewise-linear modes choose genes."""
    genes, codes = port_run[2][0]
    args = SCORING[scoring]
    model, jmodel = Model.load(dict(args)), JModel.load(dict(args))
    got = get_mea_transcripts(copy.deepcopy(genes), codes, model.props,
                              model.gcode)
    want = jmea([_to_reference(g) for g in genes], codes, jmodel.props,
                jmodel.gcode)
    assert _chosen(got) == _chosen(want)
    if scoring != "logreg":
        assert len(got) >= 1


@pytest.mark.slow
def test_mea_depth_golden_equal_to_reference():
    """The golden of chip_smoke.py's mea_depth piece (the first 21,000
    bases of io/tiled.py:tiled_record with --mea=1, the port's CPU path)
    equals augustus_tpu's GFF of the same letters.  Minutes."""
    with open(os.path.join(GOLDEN_DIR, GOLDENS["mea_depth"])) as fh:
        golden = fh.read()
    assert body(golden) == body(reference_gff("mea_depth"))
    assert golden.count("\tgene\t") >= 1
