"""GenBank input and accuracy evaluation of the port against augustus_tpu
on the CPU: the reader on both in-repo sets, the format check, the
annotation's typed exon states, the Evaluation tables on seeded
perturbations of the annotation, the whole evaluate_genbank text on the
5,612-base third record of genes_crf3.gb, the command line's GenBank branch
and cli/evaluate.py; in tests marked slow, the committed goldens of both
whole sets against augustus_tpu."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from augustus_tpu.cli import evaluate as jcli_evaluate
from augustus_tpu.io.genbank import detect_format as jdetect
from augustus_tpu.io.genbank import read_genbank as jread
from augustus_tpu.output.evaluation import Evaluation as JEvaluation
from augustus_tpu.predict import Model as JModel
from augustus_tpu.predict import anno_to_gene as janno_to_gene
from augustus_tpu.predict import evaluate_genbank as jevaluate
from augustus_tpu_torch.cli import augustus as cli
from augustus_tpu_torch.cli import evaluate as cli_evaluate
from augustus_tpu_torch.io.genbank import detect_format, read_genbank
from augustus_tpu_torch.output.evaluation import Evaluation
from augustus_tpu_torch.predict import Model, anno_to_gene, evaluate_genbank
from torch_goldens import ARGS, EVAL_SETS, GOLDEN_DIR, GOLDENS, eval_filter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
DATA = os.path.join(ROOT, "tests", "data")
SETS = ["genes_test1.gb", "genes_crf3.gb", "utrtrain.gb"]


def _states(gs):
    return [(s.begin, s.end, int(s.type)) for s in gs]


def _gene(g):
    return (g.strand, g.codingstart, g.codingend, g.transstart, g.transend,
            g.complete5utr, g.complete3utr, _states(g.exons),
            _states(g.introns), _states(g.utr5exons), _states(g.utr3exons))


@pytest.fixture(scope="module")
def third_record(tmp_path_factory):
    """genes_crf3.gb's third record (5,612 bases) as a GenBank file."""
    with open(os.path.join(DATA, "genes_crf3.gb")) as fh:
        recs = [r for r in fh.read().split("//\n") if r.strip()]
    path = tmp_path_factory.mktemp("gb") / "crf3_third.gb"
    path.write_text(recs[2] + "//\n")
    return str(path)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("with_utr", [False, True])
def test_read_genbank_equal(name, with_utr):
    path = os.path.join(DATA, name)
    got = read_genbank(path, with_utr=with_utr)
    want = jread(path, with_utr=with_utr)
    assert [(a.seqname, a.sequence, [dataclasses.asdict(g) for g in a.genes])
            for a in got] == \
        [(a.seqname, a.sequence, [dataclasses.asdict(g) for g in a.genes])
         for a in want]
    assert sum(len(a.genes) for a in got) >= len(got) >= 1


@pytest.mark.parametrize("name", ["HS04636.fa", "HS04636sm.fa",
                                  "HS08198.fa"] + SETS)
def test_detect_format_equal(name):
    path = os.path.join(DATA, name)
    assert detect_format(path) == jdetect(path)
    assert detect_format(path) == ("genbank" if name.endswith(".gb")
                                   else "fasta")


@pytest.mark.parametrize("name", SETS)
def test_anno_to_gene_equal(name):
    """Typed exon states, frames from the coding length, of every
    annotated gene (UTR exons included)."""
    path = os.path.join(DATA, name)
    for a, j in zip(read_genbank(path, with_utr=True),
                    jread(path, with_utr=True)):
        for tg, jtg in zip(a.genes, j.genes):
            assert _gene(anno_to_gene(tg, a.seqname)) == \
                _gene(janno_to_gene(jtg, j.seqname))


def _perturbed(genes, rng):
    """Copies of annotated TGenes with exon boundaries moved by up to 30
    bases (inside the sequence, order kept) and some genes dropped."""
    out = []
    for tg in genes:
        if rng.random() < 0.2:
            continue
        g = copy.deepcopy(tg)
        ex = []
        for b, e in g.exons:
            if rng.random() < 0.5:
                b = max(0, b + int(rng.integers(-30, 31)))
                e = max(b, e + int(rng.integers(-30, 31)))
            ex.append((b, e))
        g.exons = ex
        g.codingstart, g.codingend = ex[0][0], ex[-1][1]
        out.append(g)
    return out


def test_evaluation_tables_equal():
    """Both Evaluation classes fed the same annotation and seeded
    perturbations of it as the prediction, every record of all three sets
    (utrtrain.gb with its UTR exons: the UTR tables), on both strands."""
    rng = np.random.default_rng(11)
    ev, jev = Evaluation(), JEvaluation()
    for name in SETS:
        path = os.path.join(DATA, name)
        for a, j in zip(read_genbank(path, with_utr=True),
                        jread(path, with_utr=True)):
            pred = _perturbed(a.genes, rng)
            for strand in ("both", "+"):
                ev.add_to_evaluation(
                    [anno_to_gene(g, a.seqname) for g in pred],
                    [anno_to_gene(g, a.seqname) for g in a.genes], strand)
                jev.add_to_evaluation(
                    [janno_to_gene(g, j.seqname) for g in pred],
                    [janno_to_gene(g, j.seqname) for g in j.genes], strand)
    out, jout = [], []
    for e, o in ((ev, out), (jev, jout)):
        e.finish(o)
        e.print_quotients(o)
        e.print_tables(o)
    assert out == jout
    assert any("UTR exon level" in l for l in out)
    assert ev.exonTP > 0 and ev.exonFP_partial > 0 and ev.geneFN > 0


def test_eval_text_equal_on_third_record(third_record):
    """evaluate_genbank on the CPU (the device route's plain versions)
    against augustus_tpu's (engine="scan")."""
    want = jevaluate(JModel.load(dict(ARGS)), third_record, engine="scan")
    got = evaluate_genbank(Model.load(dict(ARGS)), third_record, device="cpu")
    assert eval_filter(got) == eval_filter(want)
    assert "# annotation: " in got and "\tCDS\t" in got


def test_cli_genbank_branch(third_record, capsys):
    """The command line evaluates a GenBank file with softmasking off and
    prints evaluate_genbank's text, then the command line."""
    args = {k: v for k, v in ARGS.items() if k != "softmasking"}
    assert cli.main([f"--{k}={v}" for k, v in args.items()] +
                    ["--device=cpu", third_record]) == 0
    out, cmd = capsys.readouterr().out.split("# command line:\n")
    assert cmd.startswith("# augustus --species=") and \
        "softmasking" not in cmd
    want = evaluate_genbank(Model.load(dict(ARGS)), third_record,
                            device="cpu")
    assert eval_filter(out) == eval_filter(want)


def test_cli_evaluate_equal(capsys):
    """cli/evaluate.py on an annotation against itself and against another
    set of the same records, as augustus_tpu's prints it."""
    crf3 = os.path.join(DATA, "genes_crf3.gb")
    for argv in ([crf3, crf3], [os.path.join(DATA, "genes_test1.gb"), crf3]):
        rc = cli_evaluate.main(argv)
        got = capsys.readouterr()
        jrc = jcli_evaluate.main(argv)
        want = capsys.readouterr()
        assert (rc, got.out, got.err) == (jrc, want.out, want.err)
    assert rc == 1 and "same number of sequences" in got.err


@pytest.mark.slow
@pytest.mark.parametrize("which", sorted(EVAL_SETS))
def test_eval_golden_equal_to_reference(which):
    """The committed evaluation goldens (the port's CPU path, written by
    tests/torch_goldens.py) equal augustus_tpu's evaluate_genbank text
    (engine="scan") on the whole sets.  Minutes."""
    want = jevaluate(JModel.load(dict(ARGS)),
                     os.path.join(DATA, EVAL_SETS[which]), engine="scan")
    with open(os.path.join(GOLDEN_DIR, GOLDENS[which])) as fh:
        golden = fh.read()
    assert eval_filter(golden) == eval_filter(want)
