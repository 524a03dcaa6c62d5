"""UTR gene prediction (--UTR=on, 71 states) in the port against
augustus_tpu on the CPU: the generated fixture (reproducible, every UTR
state reachable, every length column alive, the pattern weights inside
(0, 1)), the UTR parameters read by both packages field by field, the GFF
of HS04636.fa (--print_utr=on), of HS04636sm.fa softmasked with its EST
hints and of HS04636rc.fa, and the evaluation text of utrtrain.gb, each
byte-equal to its committed golden (augustus_tpu's output, written by
tests/torch_goldens.py); the goldens print tss, tts, 5'-UTR and 3'-UTR
lines.  Tests marked slow recompute the goldens with augustus_tpu, keep
the first 21,000 bases of the tiled sequence equal between the two
packages and recompute the full-size golden."""

import dataclasses
import os

import pytest
import torch

from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.convert import model_from_reference
from augustus_tpu_torch.model.state_config import ST
from augustus_tpu_torch.predict import (Model, evaluate_genbank,
                                        predict_file, predict_records)
from test_torch_model import assert_tree_equal, reference_fields
from torch_goldens import (GOLDEN_DIR, GOLDENS, UTR_ARGS, UTR_DEPTH, body,
                           eval_filter, golden_gff, utr_reference, utr_run)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plain versions run a Python loop of small torch ops
torch.set_num_threads(1)
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
UTR_TYPES = {t for t in ST if (ST.utr5single <= t <= ST.utr3term)
             or (ST.rutr5single <= t <= ST.rutr3term)}
INTRONVAR = {ST.utr5intronvar, ST.utr3intronvar, ST.rutr5intronvar,
             ST.rutr3intronvar}


def _golden(which):
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        return fh.read()


def _fields(jm):
    f = reference_fields(jm)
    f["utr"] = dataclasses.asdict(jm.utr)
    f["utr_cfg"] = dataclasses.asdict(jm.utr_cfg)
    return f


@pytest.fixture(scope="module")
def both():
    return JModel.load(dict(UTR_ARGS)), Model.load(dict(UTR_ARGS))


def test_utr_parameters_equal(both):
    """UtrParams and UtrConfig read by the port equal augustus_tpu's, field
    by field, and model_from_reference carries them across."""
    jm, m = both
    assert_tree_equal(dataclasses.asdict(jm.utr), dataclasses.asdict(m.utr),
                      "utr")
    assert dataclasses.asdict(jm.utr_cfg) == dataclasses.asdict(m.utr_cfg)
    got = model_from_reference(_fields(jm))
    assert_tree_equal(_fields(got), _fields(m))


def test_fixture_architecture(both):
    """71 states: the 47 of states_shadow.cfg at their indices, then the 24
    UTR states; every state but the hints-only intronvar ones reachable;
    the UTR model parameters inside their ranges."""
    _, m = both
    sg = m.sg
    assert sg.statecount == 71
    assert [int(t) for t in sg.state_types[47:]] == sorted(
        int(t) for t in UTR_TYPES)
    m47 = Model.load(dict(UTR_ARGS, species="repo_fixture", UTR="off"))
    assert sg.state_types[:47] == m47.sg.state_types
    reach = sg.reachable_states()
    for s, t in enumerate(sg.state_types):
        assert reach[s] == (t not in INTRONVAR), t.name
    assert abs(sg.transitions.sum(axis=1) - 1).max() < 1e-9
    assert sg.init_probs.sum() == pytest.approx(1.0, abs=1e-6)
    for key in ("utr5patternweight", "utr3patternweight"):
        assert 0.0 < m.props.get_float("/UtrModel/" + key) < 1.0
    up, uc = m.utr, m.utr_cfg
    assert uc.max3single == 5500 and uc.max3term == 3500
    for kind, dist in up.len_dist.items():
        top = uc.max3single if kind == "3single" else \
            uc.max3term if kind == "3terminal" else uc.max_exon_length
        assert dist.shape == (top + 1,), kind
        assert (dist[1:] > 0).all() and dist[0] == 0, kind


def test_fixture_is_reproducible(tmp_path, monkeypatch):
    """The committed fixture files are what make_utr_fixture.py writes, and
    its UTR parameter file keeps every block of the trained golden but
    [UTRLENGTH] byte for byte."""
    import gzip
    import importlib.util
    path = os.path.join(ROOT, "augustus_tpu_torch", "data",
                        "make_utr_fixture.py")
    spec = importlib.util.spec_from_file_location("make_utr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    for f in ("states_shadow.cfg", "trans_shadow_partial.pbl"):
        (model_dir / f).write_text(
            open(os.path.join(CONFIG, "model", f)).read())
    monkeypatch.setattr(mod, "MODEL", str(model_dir))
    monkeypatch.setattr(mod, "DST", str(tmp_path / "species"))
    mod.main()
    for f in ("states_shadow_utr.cfg", "trans_shadow_partial_utr.pbl"):
        assert open(os.path.join(CONFIG, "model", f)).read() == \
            (model_dir / f).read_text(), f
    committed = os.path.join(CONFIG, "species", "repo_fixture_utr")
    assert sorted(os.listdir(committed)) == sorted(
        os.listdir(tmp_path / "species"))
    for f in sorted(os.listdir(committed)):
        assert open(os.path.join(committed, f)).read() == \
            (tmp_path / "species" / f).read_text(), f
    with gzip.open(os.path.join(DATA, "train_golden", "utr_probs.pbl.gz"),
                   "rt") as fh:
        trained = fh.read()
    ours = open(os.path.join(committed,
                             "repo_fixture_utr_utr_probs.pbl")).read()
    tail = "#\n# AATAAA"
    assert ours[ours.index(tail):] == trained[trained.index(tail):]
    assert ours[: ours.index("[UTRLENGTH]")] == \
        trained[: trained.index("[UTRLENGTH]")]


@pytest.mark.parametrize("which", ["utr_hs04636", "utr_hints", "utr_rc"])
def test_gff_equal_to_golden(which):
    """The port's CPU path (device="cpu": the host route, K2's plain
    version, the host walk) prints augustus_tpu's committed text."""
    args, path = utr_run(which)
    got = predict_file(Model.load(dict(args)), path, device="cpu")
    assert body(got) == body(_golden(which))


def test_eval_text_equal_to_golden():
    args, path = utr_run("utr_eval")
    got = evaluate_genbank(Model.load(dict(args)), path, device="cpu")
    assert eval_filter(got) == eval_filter(_golden("utr_eval"))


@pytest.mark.parametrize("which", ["utr_hs04636", "utr_rc", "utr_tiled"])
def test_goldens_print_the_utr_lines(which):
    """tss, tts, 5'-UTR and 3'-UTR lines; the tiled golden on both
    strands, with complete genes (a tss and a tts each)."""
    text = body(_golden(which))
    rows = [line.split("\t") for line in text.splitlines()]
    for feature in ("tss", "tts", "5'-UTR", "3'-UTR"):
        strands = {r[6] for r in rows if r[2] == feature}
        assert strands, feature
        if which == "utr_tiled":
            assert strands == {"+", "-"}, feature
    genes = sum(r[2] == "gene" for r in rows)
    if which == "utr_tiled":
        assert genes >= 20
        assert sum(r[2] == "tss" for r in rows) == genes
        assert sum(r[2] == "tts" for r in rows) == genes


def test_hinted_golden_has_utr_exons_and_evidence():
    """Without --print_utr the UTR-extended exons print as exon lines; the
    hinted run prints its evidence blocks."""
    text = _golden("utr_hints")
    assert "\texon\t" in text and "\ttss\t" in text and "\ttts\t" in text
    assert "# Evidence for and against" in text


@pytest.mark.slow
@pytest.mark.parametrize("which", ["utr_hs04636", "utr_hints", "utr_rc",
                                   "utr_eval"])
def test_golden_equal_to_reference(which):
    ref = utr_reference(which)
    if which == "utr_eval":
        assert eval_filter(ref) == eval_filter(_golden(which))
    else:
        assert body(ref) == body(_golden(which))


@pytest.mark.slow
def test_tiled_depth_equal_to_reference(tmp_path):
    """The first UTR_DEPTH bases of the tiled sequence: the port's CPU path
    and augustus_tpu's scan print the same text."""
    from augustus_tpu.predict import predict_file as jpredict
    from augustus_tpu_torch.io.fasta import FastaRecord
    from augustus_tpu_torch.io.tiled import tiled_record
    rec = tiled_record(DATA)
    rec = FastaRecord(rec.name, rec.sequence[:UTR_DEPTH])
    fasta = tmp_path / "depth.fa"
    fasta.write_text(f">{rec.name}\n{rec.sequence}\n")
    ref = jpredict(JModel.load(dict(UTR_ARGS)), str(fasta), engine="scan")
    got = predict_records(Model.load(dict(UTR_ARGS)), [rec], device="cpu")
    assert body(got) == body(ref)
    assert "\ttss\t" in got and "\ttts\t" in got


@pytest.mark.slow
def test_tiled_golden_equal_to_the_cpu_path():
    """The full-size golden is the port's CPU path (about 20 minutes and
    7.4 GB)."""
    assert body(golden_gff("utr_tiled")) == body(_golden("utr_tiled"))
