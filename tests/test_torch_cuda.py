"""On an NVIDIA card: the CUDA Viterbi kernel against its plain PyTorch
version on the card, as chip_smoke.py's parity phase does.  Skipped
without a card (decided inside the tests, never at import)."""

import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _planes(species, n, device):
    from augustus_tpu_torch import genetics
    from augustus_tpu_torch.engine.device import build_tracks
    from augustus_tpu_torch.engine.gold import GoldEngine
    from augustus_tpu_torch.engine.pack import pack_tracks
    from augustus_tpu_torch.engine.viterbi import planes_for
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model
    m = Model.load({"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0"})
    seq = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0]
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(genetics.encode(seq.sequence.lower()[:n]))
    st, arr = pack_tracks(build_tracks(eng))
    return st, planes_for(st, arr, device)


@pytest.mark.cuda
@pytest.mark.parametrize("species,n", [("repo_fixture", 2500),
                                       ("repo_fixture_gc2", 6000)])
def test_kernel_equals_plain_version(cuda, species, n):
    from augustus_tpu_torch.engine.viterbi import (
        viterbi_forward, viterbi_forward_reference)
    st, planes = _planes(species, n, cuda)
    before = viterbi_forward.launches
    bp, vf, vals = viterbi_forward(st, planes, debug_vals=True)
    torch.cuda.synchronize()
    assert viterbi_forward.launches == before + 1
    rbp, rvf, rvals = viterbi_forward_reference(st, planes, True)
    S = st.S
    v, rv = vals[1:, :S].cpu().numpy(), rvals[1:, :S].cpu().numpy()
    assert np.array_equal(v.view(np.int32), rv.view(np.int32))
    live = rv > -5.0e29
    assert ((bp[1:, :S].cpu().numpy() == rbp[1:, :S].cpu().numpy())
            | ~live).all()
    assert torch.equal(vf[:S].cpu(), rvf[:S].cpu())


@pytest.mark.cuda
def test_predict_file_on_the_card_reproduces_the_golden(cuda):
    from augustus_tpu_torch.predict import Model, predict_file
    m = Model.load({"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0"})
    got = predict_file(m, os.path.join(ROOT, "tests", "data", "HS04636.fa"))
    with open(os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                           "repo_fixture_HS04636.gff")) as fh:
        golden = fh.read()

    def body(t):
        return "".join(l for l in t.splitlines(True) if not l.startswith("#"))
    assert body(got) == body(golden)
