"""The port's metaparameter optimizer (augustus_tpu_torch/pipeline/
optimize.py) against augustus_tpu's on two GenBank records of at most
6 kb cut by trainprep.gff2gb (tests/torch_pipeline_fixtures.py), trained
from the template species `generic`, 2 folds, one metaparameter with two
values: the same scores, chosen values and .pbl files.  The port evaluates
on the CPU here (the plain versions of prefix.cu, K1 and K4) and on the
card in the test marked cuda; without a card it raises unless asked for
the CPU.  augustus_tpu is imported only inside the CPU comparisons, so
that the file runs on a machine without JAX (with --noconftest)."""

import contextlib
import io
import os

import pytest
import torch

import torch_pipeline as TP
import torch_pipeline_fixtures as F

PARS = (("/Constant/dss_end", ("3", "4")),)
KFOLD = 2


@pytest.fixture(scope="module")
def small_gb(tmp_path_factory):
    from augustus_tpu_torch.pipeline.trainprep import gff2gb
    return F.write_small_gb(str(tmp_path_factory.mktemp("gb")), gff2gb)


def test_optimize_cpu_equal(small_gb, tmp_path):
    got = TP.optimize(TP.PORT, str(tmp_path / "p"), small_gb, PARS, KFOLD,
                      "cpu")
    want = TP.optimize("augustus_tpu", str(tmp_path / "j"), small_gb, PARS,
                       KFOLD)
    assert got[0] == want[0] and got[0]["/Constant/dss_end"] in ("3", "4")
    assert got[1] == want[1] and len(got[1]) == 3
    assert got[2] == want[2]
    assert "Writing exon model parameters" in got[3]


def test_cv_score_cpu_equal(small_gb, tmp_path):
    scores = []
    for pkg in ("augustus_tpu_torch", "augustus_tpu"):
        d = tmp_path / pkg
        cfg = TP.make_config(str(d / "cfg"), pkg, "cv")
        work = str(d / "work")
        os.makedirs(work)
        opt = TP.mod(pkg, "pipeline.optimize")
        buckets = opt.split_buckets(small_gb, KFOLD, work)
        kw = {"device": "cpu"} if pkg == TP.PORT else {"engine": "scan"}
        with contextlib.redirect_stdout(io.StringIO()):
            scores.append(opt.cv_score("cv", cfg, buckets,
                                       {"/Constant/dss_end": "4"}, work,
                                       **kw))
    assert scores[0] == scores[1] and scores[0] > 0


def test_optimize_raises_without_a_card(small_gb, tmp_path, monkeypatch):
    from augustus_tpu_torch.pipeline import optimize as opt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    metapars = F.write_metapars(str(tmp_path / "m.cfg"), PARS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.optimize("opt", str(tmp_path), small_gb, metapars, kfold=2,
                     workdir=str(tmp_path / "work"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.cv_score("opt", str(tmp_path), [small_gb], {}, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.main(["--species=opt", f"--AUGUSTUS_CONFIG_PATH={tmp_path}",
                  f"--metapars={metapars}", "--kfold=2", small_gb])
    # nothing was trained or written before the device check
    assert not (tmp_path / "work").exists()


@pytest.mark.cuda
def test_optimize_on_the_card(small_gb, tmp_path):
    """The same call on the card: the CPU run's scores, chosen values and
    files (the card runs prefix.cu, K1 and K4 in each evaluation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine import xputil as U
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    before = (viterbi_forward.launches, U.prefix_sum_f64.launches,
              tb.event_walk.launches)
    got = TP.optimize(TP.PORT, str(tmp_path / "cuda"), small_gb, PARS,
                      KFOLD, "cuda")
    after = (viterbi_forward.launches, U.prefix_sum_f64.launches,
             tb.event_walk.launches)
    evaluations = len(PARS[0][1]) * KFOLD
    assert all(a - b >= evaluations for a, b in zip(after, before))
    want = TP.optimize(TP.PORT, str(tmp_path / "cpu"), small_gb, PARS,
                       KFOLD, "cpu")
    assert got[:3] == want[:3]
