"""Comparative gene prediction (cgp/, --alnfile) of the port on the CPU:
CompGenePred.start on the seeded three-species input
(tests/torch_cgp_fixtures.py), its genomes read from memory and from the
SQLite store, gives augustus_tpu's <species>.cgp.gff byte for byte and
its orthoExons.<species>.gff3 but for the omega values, which LAPACK's
rounding noise decides on each host (torch_goldens.omega_masked; the
committed goldens are augustus_tpu's CompGenePred.start:
python3 tests/torch_goldens.py cgp); the live comparison of both
packages on one host, every file byte for byte, takes about 45 s of
augustus_tpu and is marked slow; every species range decoded through the
port's
predict._find_genes on the device route; and a decode that fails stops
the run (augustus_tpu goes on without it)."""

import os

import pytest
import torch

from augustus_tpu_torch import stats
from torch_goldens import CGP_FILES, GOLDEN_DIR, cgp_equal, cgp_texts

torch.set_num_threads(1)


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, "cgp_" + name)) as fh:
        return fh.read()


@pytest.mark.parametrize("store", ["mem", "sqlite"])
def test_cgp_outputs_equal_to_golden(tmp_path, store):
    stats.reset()
    got = cgp_texts("augustus_tpu_torch", str(tmp_path), store)
    # two gene ranges, three species each, all on the device route
    assert stats.COUNTS.get("device_prep") == 6
    assert set(got) == set(CGP_FILES)
    for name, text in got.items():
        assert cgp_equal(name, text, _golden(name)), name
    assert all(got[f"{s}.cgp.gff"].count("\tCDS\t") >= 1
               for s in ("hs", "mutB", "mutC"))


@pytest.mark.slow
def test_cgp_golden_equal_to_reference(tmp_path):
    """augustus_tpu's CompGenePred.start and the port's, live on one host,
    give the same files byte for byte, omega values included, and those
    equal to the goldens."""
    ref = cgp_texts("augustus_tpu", str(tmp_path / "ref"))
    got = cgp_texts("augustus_tpu_torch", str(tmp_path / "port"))
    assert got == ref
    for name, text in ref.items():
        assert cgp_equal(name, text, _golden(name)), name


def test_failed_decode_stops_the_run(tmp_path, monkeypatch):
    """No silent fallback: where augustus_tpu's _decode_exons catches the
    decode's exception and goes on with exon candidates alone, the port's
    start raises it, and writes no output."""
    import augustus_tpu_torch.predict as P

    def broken(*args, **kwargs):
        raise RuntimeError("viterbi_forward kernel launch failed")
    monkeypatch.setattr(P, "_find_genes", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        cgp_texts("augustus_tpu_torch", str(tmp_path))
    assert not os.path.exists(os.path.join(tmp_path, "out", "hs.cgp.gff"))


def test_start_needs_a_card_unless_told_otherwise(tmp_path):
    """start() resolves its device before any output file: cuda by
    default, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cgp_texts("augustus_tpu_torch", str(tmp_path), device=None)
    assert not os.path.exists(os.path.join(tmp_path, "out"))
