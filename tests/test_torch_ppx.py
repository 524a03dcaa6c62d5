"""The port's protein-profile tools (augustus_tpu_torch/ppx/*,
cli/{fastBlockSearch, pp_simScore, prepareAlign}.py) against augustus_tpu's
on seeded inputs (tests/torch_pipeline_fixtures.py: a q_ij table, an MSA of
a fixture gene's protein, its profile with [intron profile] sections):
profiles parsed alike (logQ bit-equal), texts byte-equal, scores equal."""

import os

import numpy as np
import pytest

import torch_pipeline as TP
import torch_pipeline_fixtures as F
from augustus_tpu.ppx import fastblock as jfb
from augustus_tpu.ppx import msa2prfl as jm2p
from augustus_tpu.ppx import prepare_align as jpa
from augustus_tpu.ppx import profile as jprof
from augustus_tpu.ppx import simscore as jss
from augustus_tpu_torch.ppx import fastblock as pfb
from augustus_tpu_torch.ppx import msa2prfl as pm2p
from augustus_tpu_torch.ppx import prepare_align as ppa
from augustus_tpu_torch.ppx import profile as pprof
from augustus_tpu_torch.ppx import simscore as pss


@pytest.fixture(scope="module")
def ppx(tmp_path_factory):
    """The seeded inputs and the profile (with intron sections) on disk."""
    d = str(tmp_path_factory.mktemp("ppx"))
    p = F.write_ppx(d)
    with open(p["msa"]) as fh:
        p["names"], p["rows"] = pm2p.read_msa(fh)
    p["prfl_text"] = pm2p.msa_to_prfl(p["rows"], name="fixture",
                                      qij_path=p["qij"])
    p["prfl"] = os.path.join(d, "fixture.prfl")
    with open(p["prfl"], "w") as fh:
        fh.write(F.add_intron_profiles(p["prfl_text"], p["rows"],
                                       p["where"], p["introns"]))
    return p


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def test_read_qij_bit_equal(ppx):
    (pq, pm), (jq, jm) = pm2p.read_qij(ppx["qij"]), jm2p.read_qij(ppx["qij"])
    assert np.array_equal(_bits(pq), _bits(jq))
    assert np.array_equal(_bits(pm), _bits(jm))
    assert abs(pq.sum() - 1.0) < 1e-12 and np.allclose(pq, pq.T)


def test_read_msa_equal(ppx):
    for key in ("msa", "msa_gappy"):
        with open(ppx[key]) as a, open(ppx[key]) as b:
            assert pm2p.read_msa(a) == jm2p.read_msa(b)


@pytest.mark.parametrize("min_width", [6, 10])
def test_msa_to_prfl_equal(ppx, min_width):
    got = pm2p.msa_to_prfl(ppx["rows"], name="fx", qij_path=ppx["qij"],
                           min_width=min_width)
    assert got == jm2p.msa_to_prfl(ppx["rows"], name="fx",
                                   qij_path=ppx["qij"], min_width=min_width)
    assert got.count("[block]") == len(F.block_runs(ppx["rows"], min_width))


def test_msa_to_prfl_default_qij_from_config(ppx, tmp_path, monkeypatch):
    """Without a table the port reads $AUGUSTUS_CONFIG_PATH/profile/
    default.qij."""
    (tmp_path / "profile").mkdir()
    with open(ppx["qij"]) as fh:
        (tmp_path / "profile" / "default.qij").write_text(fh.read())
    monkeypatch.setenv("AUGUSTUS_CONFIG_PATH", str(tmp_path))
    assert pm2p.default_qij_path() == str(tmp_path / "profile" /
                                          "default.qij")
    assert pm2p.msa_to_prfl(ppx["rows"], name="fixture") == ppx["prfl_text"]


def test_profile_parse_equal(ppx):
    got, want = pprof.Profile(ppx["prfl"]), jprof.Profile(ppx["prfl"])
    assert got.name == want.name == "fixture"
    assert got.block_count() == want.block_count() >= 4
    assert got.iP_lines == want.iP_lines and got.iP_lines
    assert got.trailing_iP == want.trailing_iP and got.trailing_iP
    assert (got.final_dist.min, got.final_dist.max) == \
        (want.final_dist.min, want.final_dist.max)
    assert got.global_thresh == want.global_thresh
    for a, b in zip(got.blocks, want.blocks):
        assert (a.id, a.size, a.block_numb_in_file) == \
            (b.id, b.size, b.block_numb_in_file)
        assert (a.distance.min, a.distance.max, a.distance.has_max) == \
            (b.distance.min, b.distance.max, b.distance.has_max)
        assert np.array_equal(_bits(a.logQ), _bits(b.logQ))
        assert np.array_equal(_bits(a.values), _bits(b.values))
        assert a.log_threshold == b.log_threshold


def test_profile_consts_equal(ppx):
    consts = {"min_spec": 3.0, "partial_sens": 1.5, "global_thresh": 2.0}
    got = pprof.Profile(ppx["prfl"], consts=consts)
    want = jprof.Profile(ppx["prfl"], consts=consts)
    assert [b.id for b in got.blocks] == [b.id for b in want.blocks]
    assert got.global_thresh == want.global_thresh


@pytest.mark.parametrize("strand", ["forward", "reverse"])
@pytest.mark.parametrize("cutoff", [0.5, 0.7])
def test_search_and_format_equal(ppx, strand, cutoff):
    seq = F.read_fasta(os.path.join(TP.DATA, "HS04636.fa"))["HS04636"]
    if strand == "reverse":
        seq = F.revcomp(seq)
    got_groups = pfb.search(seq.lower(), pprof.Profile(ppx["prfl"]),
                            cutoff=cutoff)
    want_groups = jfb.search(seq.lower(), jprof.Profile(ppx["prfl"]),
                             cutoff=cutoff)
    got = pfb.format_results(strand, got_groups)
    assert got == jfb.format_results(strand, want_groups)
    if cutoff == 0.5:
        assert got_groups and "fixture_" in got


@pytest.mark.parametrize("kw", [
    {}, {"intron_weight_inter": 0.0, "gap_inter": -3.0},
    {"intron_weight_intra": 0.0, "intron_weight_inter": 0.0},
    {"gap_intron": -2.0, "epsi_intron": 1e-5, "epsi_no_intron": 0.2}])
def test_similarity_score_equal(ppx, kw):
    got, want = pss.SimilarityScore(**kw), jss.SimilarityScore(**kw)
    got.read(ppx["protein"], ppx["prfl"])
    want.read(ppx["protein"], ppx["prfl"])
    assert got.num_prot == want.num_prot == F.PPX_ROWS
    got.fill()
    want.fill()
    assert _bits(got.score()) == _bits(want.score())
    assert np.isfinite(got.score())


def test_prepare_align_equal(ppx):
    with open(ppx["msa_gappy"]) as fh:
        names, rows = pm2p.read_msa(fh)
    got = ppa.prepare_align(list(names), list(rows))
    assert got == jpa.prepare_align(list(names), list(rows))
    assert "gappy" not in got[0] and len(got[0]) == F.GAPPY_WITH
    # an alignment without the gap-riddled row stays as it is
    kept = ppa.prepare_align(names[:-1], rows[:-1])
    assert kept[0] == names[:-1]


def test_ppx_phase_equal_and_golden(tmp_path):
    """The four outputs of chip_smoke.py's ppx phase (the command lines in
    process) from both packages, and equal to the goldens."""
    got = TP.ppx(TP.PORT, str(tmp_path / "p"))
    assert got == TP.ppx("augustus_tpu", str(tmp_path / "j"))
    for name, text in got.items():
        assert text == TP.golden(name), name
