"""End to end on the CPU: the port's predict_file and CLI against
augustus_tpu predict_file(engine="scan"), GFF byte-equal without '#'
lines, and the committed golden kept equal to the reference."""

import os
import subprocess
import sys

import pytest
import torch

from augustus_tpu.predict import Model as JModel, predict_file as jpredict
from augustus_tpu_torch.predict import Model, predict_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                      "repo_fixture_HS04636.gff")
DATA = os.path.join(ROOT, "tests", "data")
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}


def body(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


@pytest.fixture(scope="module")
def reference():
    jm = JModel.load(dict(ARGS))
    return {f: jpredict(jm, os.path.join(DATA, f), engine="scan")
            for f in ("HS04636.fa", "HS08198.fa")}


@pytest.mark.parametrize("fasta,min_genes", [("HS04636.fa", 1),
                                             ("HS08198.fa", 0)])
def test_gff_equal_to_reference(reference, fasta, min_genes):
    got = predict_file(Model.load(dict(ARGS)), os.path.join(DATA, fasta),
                       device="cpu")
    assert body(got) == body(reference[fasta])
    assert got.count("\tgene\t") >= min_genes


def test_golden_equal_to_reference(reference):
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert body(golden) == body(reference["HS04636.fa"])
    assert golden.count("\tgene\t") >= 1


def _tiled_golden() -> str:
    from torch_goldens import GOLDEN_DIR, GOLDENS
    with open(os.path.join(GOLDEN_DIR, GOLDENS["tiled"])) as fh:
        return fh.read()


def test_tiled_golden_is_a_prediction_on_the_tiled_sequence():
    """The committed full-size golden names the sequence that
    augustus_tpu_torch/io/tiled.py builds, and its genes lie inside it."""
    from augustus_tpu_torch.io.tiled import tiled_record
    rec = tiled_record(DATA)
    golden = _tiled_golden()
    assert f"(length = {len(rec.sequence)}, name = {rec.name})" in golden
    genes = [l.split("\t") for l in body(golden).splitlines()
             if "\tgene\t" in l]
    assert len(genes) >= 1
    for g in genes:
        assert g[0] == rec.name
        assert 1 <= int(g[3]) <= int(g[4]) <= len(rec.sequence)


@pytest.mark.slow
def test_tiled_golden_equal_to_the_cpu_path():
    """The full-size golden is what the port's CPU path gives, the path
    that test_gff_equal_to_reference holds to augustus_tpu (a quarter of
    an hour and several GB)."""
    from torch_goldens import golden_gff
    assert body(_tiled_golden()) == body(golden_gff("tiled"))


def test_cli_prints_the_same_text():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "augustus_tpu_torch.cli.augustus",
           "--species=repo_fixture", f"--AUGUSTUS_CONFIG_PATH={CONFIG}",
           "--UTR=off", "--softmasking=0", "--device=cpu",
           os.path.join(DATA, "HS04636.fa")]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN) as fh:
        assert body(r.stdout) == body(fh.read())
    assert "# command line:" in r.stdout
