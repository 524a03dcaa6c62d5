"""Softmasked, EST-hinted prediction end to end on the CPU: the port's
predict_file and CLI against augustus_tpu predict_file(engine="scan"), GFF
byte-equal without '#' lines (evidence blocks are '#' lines and are
compared on their own), in one piece and in pieces of 3,000 bases (the
cut-point search with hint-group gaps and the hints of each piece)."""

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
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints",
                     "HS04636sm.E.gff")
GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                      "repo_fixture_HS04636sm_hints.gff")
FASTA = os.path.join(ROOT, "tests", "data", "HS04636sm.fa")
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "1", "hintsfile": HINTS,
        "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}
PIECES = {"one_piece": {}, "pieces_of_3000": {"maxDNAPieceSize": "3000"}}


def body(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def evidence(text: str) -> str:
    lines = text.splitlines(True)
    out, on = [], False
    for l in lines:
        on = on or l.startswith("# Evidence for and against")
        if on:
            out.append(l)
        on = on and not l.startswith("# incompatible hint groups")
    return "".join(out)


@pytest.fixture(scope="module")
def reference():
    return {k: jpredict(JModel.load(dict(ARGS, **extra)), FASTA,
                        engine="scan") for k, extra in PIECES.items()}


@pytest.mark.parametrize("pieces", sorted(PIECES))
def test_hinted_gff_equal_to_reference(reference, pieces):
    got = predict_file(Model.load(dict(ARGS, **PIECES[pieces])), FASTA,
                       device="cpu")
    ref = reference[pieces]
    assert body(got) == body(ref)
    assert evidence(got) == evidence(ref)
    assert got.count("\tgene\t") >= 1
    assert got.count("# Evidence for and against") == got.count("\tgene\t")
    assert "# hint groups fully obeyed:" in got


def test_hinted_golden_equal_to_reference(reference):
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert body(golden) == body(reference["one_piece"])
    assert evidence(golden) == evidence(reference["one_piece"])


def _cli(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "augustus_tpu_torch.cli.augustus",
           "--species=repo_fixture", f"--AUGUSTUS_CONFIG_PATH={CONFIG}",
           "--UTR=off", "--softmasking=1", f"--hintsfile={HINTS}",
           "--extrinsicCfgFile=extrinsic.M.RM.E.W.cfg"] + extra + [FASTA]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)


def test_cli_with_hints_prints_the_golden():
    r = _cli(["--device=cpu"])
    assert r.returncode == 0, r.stderr
    with open(GOLDEN) as fh:
        golden = fh.read()
    assert body(r.stdout) == body(golden)
    assert evidence(r.stdout) == evidence(golden)
    assert "# Have extrinsic information about 1 sequences" in r.stdout


def test_cli_with_hints_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    r = _cli([])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "\tgene\t" not in r.stdout
