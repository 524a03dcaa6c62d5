"""UTR sampling on the CPU (--UTR=on with --sample), the port against
augustus_tpu: the sampling walk over one forward table of the 71-state UTR
fixture (augustus_tpu's, given to both packages, so that the walk alone and
its UTR candidates, engine/gold_utr.py:utr_cands, are compared), and the
sampled GFF of tests/data/HS04636.fa (--print_utr=on --sample=100
--alternatives-from-sampling=true: K2's plain version for the path, K5's
for the forward table, the host walk) byte-equal without '#' lines to the
committed golden, which is augustus_tpu's output.  Marked slow: the golden
recomputed with augustus_tpu, and the golden of chip_smoke.py's
utr_sample_depth piece (the port's CPU path) equal to augustus_tpu's GFF
of the same letters.  tests/test_torch_utr_sampling_hints.py and
tests/test_torch_utr_mea.py hold the hinted and the MEA goldens."""

import os
import tempfile

import pytest
import torch

from augustus_tpu import genetics as jgenetics
from augustus_tpu.crand import GlibcRand as JRand
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.engine.scan import ForwardEngine as JForward
from augustus_tpu.predict import Model as JModel, predict_file as jpredict
from augustus_tpu_torch import genetics
from augustus_tpu_torch.crand import GlibcRand
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.engine.scan import scan_forward, scan_table
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, predict_file
from torch_goldens import (DATA, GOLDEN_DIR, GOLDENS, UTR_SAMPLED, body,
                           depth_record, utr_reference)

# the plain versions run a Python loop of small torch ops
torch.set_num_threads(1)
N_WALK, DRAWS = 3000, 30


def golden(which: str) -> str:
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        return fh.read()


def engines(jm, m):
    return (JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
                  utr=jm.utr, utr_cfg=jm.utr_cfg),
            GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode,
                       utr=m.utr, utr_cfg=m.utr_cfg))


@pytest.fixture(scope="module")
def utr_table():
    """augustus_tpu's forward table of the first N_WALK bases with the UTR
    fixture."""
    seq = read_fasta(os.path.join(DATA, "HS04636.fa"))[0].sequence[:N_WALK]
    je, _ = engines(JModel.load(dict(UTR_SAMPLED)),
                    Model.load(dict(UTR_SAMPLED)))
    je.prepare(jgenetics.encode(seq.lower()))
    return seq, JForward(jbuild(je)).run()


@pytest.mark.parametrize("temperature", [0, 3])
def test_utr_sample_walk_equal(utr_table, temperature):
    """GoldEngine.sample_path of both packages over the same UTR table and
    the same rand() stream: identical segment lists for DRAWS draws, UTR
    states among them (with --temperature=3 through the heated candidate
    weights)."""
    seq, f = utr_table
    args = dict(UTR_SAMPLED, temperature=str(temperature))
    je, e = engines(JModel.load(dict(args)), Model.load(dict(args)))
    je.prepare(jgenetics.encode(seq.lower()))
    e.prepare(genetics.encode(seq.lower()))
    je.f, e.f = f, f.copy()
    je._classify_states()
    e._classify_states()
    jr, r = JRand(1), GlibcRand(1)
    distinct, types = set(), set()
    for _ in range(DRAWS):
        want = je.sample_path(jr)
        got = e.sample_path(r)
        assert got == want
        distinct.add(tuple(got))
        types |= {seg[2] for seg in got}
    assert len(distinct) > 1
    assert any("utr" in t.name for t in types)


def test_utr_sampled_gff_equal_to_golden():
    """The port's CPU GFF (plain versions of K2 and K5, no launch) equals
    the committed golden, augustus_tpu's text: alternative transcripts
    with their posteriors, tss and tts lines, UTR exons."""
    before = (scan_forward.launches, scan_table.launches)
    got = predict_file(Model.load(dict(UTR_SAMPLED)),
                       os.path.join(DATA, "HS04636.fa"), device="cpu")
    assert (scan_forward.launches, scan_table.launches) == before
    assert body(got) == body(golden("utr_sample"))
    tx = [l.split("\t") for l in body(got).splitlines()
          if "\ttranscript\t" in l]
    assert len(tx) > 1 and any(float(t[5]) < 1 for t in tx)
    for line in ("\ttss\t", "\ttts\t", "\t5'-UTR\t", "\t3'-UTR\t"):
        assert line in got


@pytest.mark.slow
def test_utr_sample_golden_equal_to_reference():
    """The committed golden is augustus_tpu's text.  About a minute."""
    assert body(golden("utr_sample")) == body(utr_reference("utr_sample"))


@pytest.mark.slow
def test_utr_sample_depth_golden_equal_to_reference():
    """The golden of chip_smoke.py's utr_sample_depth piece (the first
    21,000 bases of io/tiled.py:tiled_record, sampled as above, the port's
    CPU path) equals augustus_tpu's GFF of the same letters (engine="scan",
    JAX on the CPU).  Minutes."""
    rec = depth_record()
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "depth.fa")
        with open(fasta, "w") as fh:
            fh.write(f">{rec.name}\n{rec.sequence}\n")
        ref = jpredict(JModel.load(dict(UTR_SAMPLED)), fasta, engine="scan")
    text = golden("utr_sample_depth")
    assert body(text) == body(ref)
    assert text.count("\ttranscript\t") > text.count("\tgene\t") >= 1
