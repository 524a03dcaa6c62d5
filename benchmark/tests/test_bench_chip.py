"""One short run of each cell on the card (marker `cuda`; skipped without
one): the result line keeps to the contract and `correct` is true."""

import json
import os
import subprocess
import sys

import pytest

from benchlib import spec as S


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fly47.chrom"])
def test_a_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, os.path.join(S.BENCH_DIR, "run.py"), "--workload",
         cell, "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=S.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mb_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
