"""Sampling on the CPU, the port against augustus_tpu: the glibc rand()
stream, the sampling walk over one forward table (augustus_tpu's, given to
both packages, so that the walk alone is compared), the sampled GFF of
tests/data/HS04636.fa (--sample=100 --alternatives-from-sampling=true)
byte-equal without '#' lines, the committed golden kept equal to it, and
the refusals of what is not ported."""

import os

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
from augustus_tpu_torch.engine.forward import forward_table
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, predict_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
PKG_DATA = os.path.join(ROOT, "augustus_tpu_torch", "data")
CONFIG = os.path.join(PKG_DATA, "config")
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(PKG_DATA, "golden", "repo_fixture_HS04636_sample100.gff")
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}
SAMPLED = dict(ARGS, sample="100")
SAMPLED["alternatives-from-sampling"] = "true"
N_WALK, DRAWS = 6000, 30


def body(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def test_rand_stream_equal():
    """The first 10^5 draws of the two glibc rand() replicas."""
    a, b = GlibcRand(1), JRand(1)
    assert [a.rand() for _ in range(100_000)] == \
        [b.rand() for _ in range(100_000)]


@pytest.fixture(scope="module")
def forward_table_6kb():
    """augustus_tpu's forward table of the first N_WALK bases."""
    jm = JModel.load(dict(ARGS))
    seq = read_fasta(os.path.join(DATA, "HS04636.fa"))[0].sequence[:N_WALK]
    je = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode)
    je.prepare(jgenetics.encode(seq.lower()))
    return seq, JForward(jbuild(je)).run()


@pytest.mark.parametrize("temperature", [0, 3])
def test_sample_walk_equal(forward_table_6kb, temperature):
    """GoldEngine.sample_path of both packages over the same table and the
    same rand() stream: identical segment lists for DRAWS draws (with
    --temperature=3 through the heated candidate weights)."""
    seq, f = forward_table_6kb
    args = dict(ARGS, temperature=str(temperature))
    jm, m = JModel.load(dict(args)), Model.load(dict(args))
    je = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode)
    e = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    je.prepare(jgenetics.encode(seq.lower()))
    e.prepare(genetics.encode(seq.lower()))
    je.f, e.f = f, f.copy()
    je._classify_states()
    e._classify_states()
    jr, r = JRand(1), GlibcRand(1)
    distinct = set()
    for _ in range(DRAWS):
        want = je.sample_path(jr)
        got = e.sample_path(r)
        assert got == want
        distinct.add(tuple(got))
    assert len(distinct) > 1


@pytest.fixture(scope="module")
def reference():
    return jpredict(JModel.load(dict(SAMPLED)),
                    os.path.join(DATA, "HS04636.fa"), engine="scan")


def test_sampled_gff_equal_to_reference(reference):
    before = forward_table.launches
    got = predict_file(Model.load(dict(SAMPLED)),
                       os.path.join(DATA, "HS04636.fa"), device="cpu")
    assert forward_table.launches == before        # plain version on CPU
    assert body(got) == body(reference)
    # alternative transcripts with their posterior probabilities
    tx = [l.split("\t") for l in body(got).splitlines()
          if "\ttranscript\t" in l]
    assert len(tx) > 1 and any(float(t[5]) < 1 for t in tx)


def test_sample_golden_equal_to_reference(reference):
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert body(golden) == body(reference)
    assert golden.count("\tgene\t") >= 1


@pytest.mark.parametrize("flag,missing", [
    ("mea", "MEA"),
    ("alternatives-from-evidence", "alternatives-from-evidence")])
def test_out_of_slice_flags_refused(flag, missing):
    with pytest.raises(NotImplementedError, match=missing):
        Model.load(dict(SAMPLED, **{flag: "true"}))


def test_heat_with_exon_hints_refused():
    """A heated forward of a piece with sparse exon hints is refused before
    any decode, as augustus_tpu refuses it."""
    args = dict(SAMPLED, softmasking="1", temperature="3",
                extrinsicCfgFile="extrinsic.M.RM.E.W.cfg",
                hintsfile=os.path.join(PKG_DATA, "hints", "HS04636sm.E.gff"))
    with pytest.raises(NotImplementedError, match="temperature"):
        predict_file(Model.load(args), os.path.join(DATA, "HS04636sm.fa"),
                     device="cpu")
