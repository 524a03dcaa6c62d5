"""CRF training of the port (augustus_tpu_torch/training/crf.py) against
augustus_tpu on the CPU: a species trained on genes_test1.gb, then two CRF
rounds on the held-out third record of genes_crf3.gb, which that species
mispredicts, so that the update fires; the port's predictions take the
plain versions of its kernels (device "cpu"), augustus_tpu's its XLA scan
engine.  The emission tables are held bit for bit after every chunk.  Then
run_training with --CRF=on on that record alone (every file, the .HMM
copies included), and the committed training goldens: the port's
predictions with the golden species on the CPU equal to augustus_tpu's
golden texts, and, in tests marked slow, the goldens recomputed by both
packages."""

import importlib
import os

import numpy as np
import pytest
import torch

from torch_goldens import body, eval_filter, train_golden_texts
from torch_training import (DATA, PKGS, TRAIN_SETS, golden_name,
                            held_out_gb, make_config, predict_args,
                            read_golden, species_files, species_from_goldens,
                            train)

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)


def _tables(model) -> list:
    """Every table that the CRF update moves, copied: per GC class the
    three exon frames and the intron emissions."""
    out = []
    for c in range(len(model.exp.gc)):
        out += [np.array(model.exp.gc[c].emiprobs[f], dtype=np.float64)
                for f in range(3)]
        out.append(np.array(model.inp.gc[c].emiprobs, dtype=np.float64))
    return out


def _crf_run(pkg: str, cfg: str, gb: str) -> dict:
    """Two CRF rounds of `pkg` on the single-gene sequences of gb: the
    tables before and after every chunk, the log, the counts, and each
    Evaluation call's outcome."""
    predict = importlib.import_module(pkg + ".predict")
    evaluation = importlib.import_module(pkg + ".output.evaluation")
    genbank = importlib.import_module(pkg + ".io.genbank")
    annotation = importlib.import_module(pkg + ".training.annotation")
    crf = importlib.import_module(pkg + ".training.crf")
    model = predict.Model.load(predict_args(cfg, "crf", "crf3"))
    singles = annotation.split_to_single_gene_seqs(
        genbank.read_genbank(gb))
    run = {"before": _tables(model), "chunks": [], "log": [],
           "evaluations": []}

    def log(msg):
        run["log"].append(msg)
        if msg.startswith("chunk"):
            run["chunks"].append(_tables(model))

    add = evaluation.Evaluation.add_to_evaluation

    def recorded(self, *a, **k):
        try:
            out = add(self, *a, **k)
        except Exception as e:
            run["evaluations"].append(repr(e))
            raise
        run["evaluations"].append("ok")
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluation.Evaluation, "add_to_evaluation", recorded)
        if pkg == "augustus_tpu":
            trainer = crf.CRFTrainer(model, rounds=2, chunksize=2)
            trainer.train(singles, engine="scan", log=log)
        else:
            trainer = crf.CRFTrainer(model, rounds=2, chunksize=2,
                                     device="cpu")
            trainer.train(singles, log=log)
    run.update(singles=len(singles), seen=trainer.num_seen,
               correct=trainer.num_correct)
    return run


@pytest.fixture(scope="module")
def crf_runs(tmp_path_factory):
    """{package: run} on the species of genes_test1.gb (the port's files,
    byte-equal to augustus_tpu's by test_torch_training.py)."""
    tmp = str(tmp_path_factory.mktemp("crf"))
    cfg = make_config(tmp + "/cfg", "augustus_tpu_torch", "crf")
    train("augustus_tpu_torch", cfg, "crf",
          os.path.join(DATA, "genes_test1.gb"))
    gb = held_out_gb(tmp)
    return {pkg: _crf_run(pkg, cfg, gb) for pkg in PKGS}


def _bits(tables):
    return [t.view(np.int64) for t in tables]


def test_crf_tables_bit_equal_after_every_chunk(crf_runs):
    want, got = crf_runs["augustus_tpu"], crf_runs["augustus_tpu_torch"]
    assert len(got["chunks"]) == len(want["chunks"]) == 2
    for a, b in zip([want["before"]] + want["chunks"],
                    [got["before"]] + got["chunks"]):
        assert len(a) == len(b)
        for x, y in zip(_bits(a), _bits(b)):
            assert np.array_equal(x, y)


def test_crf_counts_equal(crf_runs):
    """The same genes seen and predicted correctly, the same log lines
    (the updates of every chunk, the correct counts of every round)."""
    want, got = crf_runs["augustus_tpu"], crf_runs["augustus_tpu_torch"]
    assert (got["singles"], got["seen"], got["correct"]) == \
        (want["singles"], want["seen"], want["correct"]) == (1, 2, 0)
    assert got["log"] == want["log"]
    assert "updated 1 of 1" in got["log"][1]


def test_crf_loss_takes_the_evaluation_branch(crf_runs):
    """_loss's coverage fallback (taken on any exception of Evaluation) is
    not what gives the margin: every Evaluation call returned."""
    for pkg in PKGS:
        assert crf_runs[pkg]["evaluations"] == ["ok", "ok"], pkg


def test_crf_tables_moved(crf_runs):
    """The update moved the tables, which stay distributions."""
    run = crf_runs["augustus_tpu_torch"]
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(run["before"], run["chunks"][-1]))
    assert moved > 1e-3
    for t in run["chunks"][-1]:
        np.testing.assert_allclose(t.reshape(-1, 4).sum(axis=1), 1.0,
                                   rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def crf_trained(tmp_path_factory):
    """run_training --CRF=on --CRF_N=1 of both packages on the held-out
    record alone: {package: {file: text}}."""
    tmp = str(tmp_path_factory.mktemp("crf_n1"))
    gb = held_out_gb(tmp)
    out = {}
    for pkg in PKGS:
        cfg = make_config(os.path.join(tmp, pkg), pkg, "sp")
        out[pkg] = species_files(train(pkg, cfg, "sp", gb, CRF="on",
                                       CRF_N="1"))
    return out


@pytest.mark.parametrize("name", [
    "sp_exon_probs.pbl", "sp_intron_probs.pbl", "sp_igenic_probs.pbl",
    "sp_exon_probs.pbl.HMM", "sp_intron_probs.pbl.HMM"])
def test_run_training_crf_files_byte_equal(crf_trained, name):
    want, got = crf_trained["augustus_tpu"], crf_trained["augustus_tpu_torch"]
    assert sorted(got) == sorted(want)
    assert name in got
    assert got[name] == want[name]


@pytest.mark.parametrize("which,run", [
    ("crf3", "HS04636"),
    pytest.param("crf3", "eval_test1", marks=pytest.mark.slow),
    ("utr", "HS04636")])
def test_golden_species_predict_like_the_goldens(tmp_path, which, run):
    """The port's CPU path with the species of the committed training
    goldens gives augustus_tpu's committed texts (chip_smoke.py's train
    phase holds the card to the same)."""
    from augustus_tpu_torch.predict import (Model, evaluate_genbank,
                                            predict_file)
    cfg = species_from_goldens(str(tmp_path), "augustus_tpu_torch", which,
                               "sp")
    model = Model.load(predict_args(cfg, "sp", which))
    if run == "eval_test1":
        text = evaluate_genbank(model, os.path.join(DATA, "genes_test1.gb"),
                                device="cpu")
        want = read_golden(golden_name(which, "_eval_test1.out"))
        assert eval_filter(text) == eval_filter(want)
        return
    text = predict_file(model, os.path.join(DATA, "HS04636.fa"),
                        device="cpu")
    assert body(text) == body(read_golden(golden_name(which,
                                                      "_HS04636.gff")))
    assert text.count("\tgene\t") >= 1


@pytest.mark.slow
@pytest.mark.parametrize("which", sorted(TRAIN_SETS))
def test_training_goldens_recomputed(tmp_path, which):
    """augustus_tpu's training goldens computed anew, and the port's CPU
    training of the same set (CRF rounds on genes_crf3.gb) equal to them
    file for file."""
    texts = train_golden_texts(which, str(tmp_path / "ref"))
    for name, text in texts.items():
        assert read_golden(name) == text, name
    queryfile, extra, suffixes = TRAIN_SETS[which]
    cfg = make_config(str(tmp_path / "port"), "augustus_tpu_torch", "sp")
    got = species_files(train("augustus_tpu_torch", cfg, "sp",
                              os.path.join(DATA, queryfile), **extra))
    for suffix in suffixes:
        assert got["sp" + suffix] == read_golden(golden_name(which, suffix))
