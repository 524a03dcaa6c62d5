"""Sampling with a lessD window wider than K3 holds, on the CPU: the
species repo_fixture_wide (augustus_tpu_torch/data/make_wide_intron_
fixture.py: trained by the port's etraining from `generic` with
/IntronModel/d 120, a window of 79 bases) sampled with --sample=100.
forward.k3_fits refuses the piece before any launch, so it takes K2 for
the path and K5 for the forward table (their plain versions here), and
the GFF equals augustus_tpu's: live on the first SLICE bases, and the
committed golden (augustus_tpu's, all of HS04636.fa) under -m slow."""

import os

import pytest
import torch

from augustus_tpu_torch import stats
from augustus_tpu_torch.engine.pack import pack_tracks
from augustus_tpu_torch.engine.forward import k3_fits
from augustus_tpu_torch.predict import Model, predict_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                      "repo_fixture_wide_HS04636_sample100.gff")
ARGS = {"species": "repo_fixture_wide", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0", "sample": "100",
        "alternatives-from-sampling": "true"}
SLICE = 1500
torch.set_num_threads(1)


def _slice(tmp_path) -> str:
    with open(os.path.join(DATA, "HS04636.fa")) as fh:
        lines = fh.read().splitlines()
    seq = "".join(lines[1:])[:SLICE]
    path = tmp_path / "HS04636_slice.fa"
    path.write_text(lines[0] + "\n" + "\n".join(
        seq[i: i + 60] for i in range(0, len(seq), 60)) + "\n")
    return str(path)


def test_window_is_past_k3():
    """The species' lessD window is 79 bases: K1 holds the piece, K3 does
    not."""
    from augustus_tpu_torch.engine.device import build_tracks
    from augustus_tpu_torch.engine.viterbi import k1_fits
    from augustus_tpu_torch.genetics import encode
    from augustus_tpu_torch.predict import _new_gold
    m = Model.load(dict(ARGS))
    with open(os.path.join(DATA, "HS04636.fa")) as fh:
        seq = "".join(fh.read().splitlines()[1:])[:600]
    gold = _new_gold(m, False, False)
    gold.prepare(encode(seq.lower()))
    st, arr = pack_tracks(build_tracks(gold))
    assert max(d.window for d in st.lessd) == 79
    assert k1_fits(st, arr) and not k3_fits(st, arr)


def test_sampled_slice_equal_to_reference(tmp_path):
    """The first 1,500 bases sampled: K2 + K5, the GFF equal to
    augustus_tpu's predict_file (its scan and forward table on the CPU)."""
    from augustus_tpu.predict import Model as JModel, predict_file as jpf
    fasta = _slice(tmp_path)
    stats.reset()
    got = predict_file(Model.load(dict(ARGS)), fasta, device="cpu")
    assert stats.COUNTS.get("k3_capacity_to_k5") == 1
    assert got.count("\tgene\t") >= 1
    assert got == jpf(JModel.load(dict(ARGS)), fasta, engine="scan")


@pytest.mark.slow
def test_sampled_golden_equal(tmp_path):
    """All of HS04636.fa sampled on the port's CPU path (about 70 s) gives
    the committed golden, augustus_tpu's text."""
    got = predict_file(Model.load(dict(ARGS)),
                       os.path.join(DATA, "HS04636.fa"), device="cpu")
    with open(GOLDEN) as fh:
        assert got == fh.read()
