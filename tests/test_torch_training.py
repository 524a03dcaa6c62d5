"""Supervised training of the port (augustus_tpu_torch/training,
cli/etraining.py) against augustus_tpu on the CPU: the template species
and its generator, new_species, the .pbl files of both packages on the
same GenBank sets (exon, intron and intergenic model with one and two GC
classes; all four with --UTR=on), the numpy helpers on seeded inputs bit
for bit, and the refusal to run the CRF rounds without a card.  The CRF
cases are in test_torch_training_crf.py."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from torch_training import (CONFIG, DATA, MODELS, PKGS, ROOT, UTR_TRAIN,
                            make_config, species_files, train, train_args)

# (GenBank set, extra arguments) of the maximum-likelihood cases
ML_CASES = {"crf3_gc1": ("genes_crf3.gb", {}),
            "crf3_gc2": ("genes_crf3.gb",
                         {"/Constant/decomp_num_steps": "2"}),
            "test1_gc1": ("genes_test1.gb", {}),
            "test1_gc2": ("genes_test1.gb",
                          {"/Constant/decomp_num_steps": "2"})}


def _trained(tmp_path_factory, queryfile, extra):
    """{package: {file: text}} of the species each package trained."""
    out = {}
    for pkg in PKGS:
        cfg = make_config(str(tmp_path_factory.mktemp(pkg)), pkg, "sp")
        out[pkg] = species_files(train(pkg, cfg, "sp",
                                       os.path.join(DATA, queryfile),
                                       **extra))
    return out


@pytest.fixture(scope="module", params=sorted(ML_CASES))
def ml_trained(request, tmp_path_factory):
    queryfile, extra = ML_CASES[request.param]
    return dict(_trained(tmp_path_factory, queryfile, extra),
                classes=int(extra.get("/Constant/decomp_num_steps", 1)))


@pytest.fixture(scope="module")
def utr_trained(tmp_path_factory):
    return _trained(tmp_path_factory, "utrtrain.gb", UTR_TRAIN)


def test_template_is_reproducible(tmp_path, monkeypatch):
    """The committed template is what make_train_fixture.py writes."""
    path = os.path.join(ROOT, "augustus_tpu_torch", "data",
                        "make_train_fixture.py")
    spec = importlib.util.spec_from_file_location("make_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DST", str(tmp_path))
    mod.main()
    committed = os.path.join(CONFIG, "species", "generic")
    assert os.listdir(committed) == ["generic_parameters.cfg"]
    assert species_files(committed) == species_files(str(tmp_path))


def test_create_species_equal(tmp_path):
    """new_species of both packages writes the same species directory, the
    template's name replaced and its remark dropped."""
    dirs = [make_config(str(tmp_path / pkg), pkg, "my_species")
            for pkg in PKGS]
    files = [species_files(os.path.join(d, "species", "my_species"))
             for d in dirs]
    assert files[0] == files[1]
    assert list(files[1]) == ["my_species_parameters.cfg"]
    text = files[1]["my_species_parameters.cfg"]
    assert "/ExonModel/outfile              my_species_exon_probs.pbl" \
        in text
    assert "use as template" not in text


@pytest.mark.parametrize("model", MODELS)
def test_pbl_byte_equal(ml_trained, model):
    """Each .pbl of the port equals augustus_tpu's byte for byte; both
    wrote exactly the three files of the template's state list."""
    want, got = ml_trained["augustus_tpu"], ml_trained["augustus_tpu_torch"]
    assert sorted(got) == sorted(want) == [
        "sp_exon_probs.pbl", "sp_igenic_probs.pbl", "sp_intron_probs.pbl",
        "sp_parameters.cfg"]
    name = f"sp_{model}_probs.pbl"
    assert got[name] == want[name]


@pytest.mark.parametrize("model", MODELS + ("utr",))
def test_utr_training_byte_equal(utr_trained, model):
    """--UTR=on with --/EHMMTraining/statecount=4 on utrtrain.gb: all four
    files written, each byte-equal (UtrTrainer mixes its GC parameters
    with the intron chain, etraining.py's store_gc)."""
    want, got = utr_trained["augustus_tpu"], utr_trained["augustus_tpu_torch"]
    assert sorted(got) == sorted(want)
    name = f"sp_{model}_probs.pbl"
    assert name in got
    assert got[name] == want[name]


@pytest.mark.parametrize("model", MODELS)
def test_one_block_per_gc_class(ml_trained, model):
    """Each file holds one block of GC-dependent parameters per class."""
    got = ml_trained["augustus_tpu_torch"][f"sp_{model}_probs.pbl"]
    blocks = re.findall(r"^\[(\d+)\]$", got, flags=re.M)
    assert blocks == [str(c + 1) for c in range(ml_trained["classes"])]


def test_no_state_list_writes_nothing(tmp_path):
    """A state list of no models writes no file in either package and
    raises nothing (etraining.py builds trainers only for the listed
    names)."""
    for pkg in PKGS:
        cfg = make_config(str(tmp_path / pkg), pkg, "sp")
        d = train(pkg, cfg, "sp", os.path.join(DATA, "genes_test1.gb"),
                  **{"/EHMMTraining/statecount": "0"})
        assert os.listdir(d) == ["sp_parameters.cfg"]


def _modules(pkg):
    return {m: importlib.import_module(f"{pkg}.training.{m}")
            for m in ("smooth", "probs", "motif", "fmt")}


J, T = _modules("augustus_tpu"), _modules("augustus_tpu_torch")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smooth_counts_bit_equal(seed):
    rng = np.random.default_rng(seed)
    counts = [int(c) if rng.random() < 0.3 else 0
              for c in rng.integers(1, 20, size=300)]
    for mwc, slope, rsize, prior in ((1, 0.1, -1, 0), (10, 0.3, 200, 0),
                                     (3, 0.2375, -1, 400)):
        a = J["smooth"].smooth_counts(counts, mwc, slope, rsize, prior)
        b = T["smooth"].smooth_counts(counts, mwc, slope, rsize, prior)
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.int64), b.view(np.int64))
        assert np.array_equal(
            J["smooth"].scale_dbl_vector(a.copy()).view(np.int64),
            T["smooth"].scale_dbl_vector(b.copy()).view(np.int64))


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_probs_from_counts_bit_equal(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 30, size=4 ** (k + 1)).astype(np.int64)
    counts[rng.random(counts.shape) < 0.2] = 0
    short = J["probs"].determine_short_patterns(counts, k, 40)
    assert np.array_equal(
        short, T["probs"].determine_short_patterns(counts, k, 40))
    for short in (None, short):
        for pseudo in (1.0, 5.0, 0.00266):
            a = J["probs"].make_probs_from_counts(counts, k, pseudo, short)
            b = T["probs"].make_probs_from_counts(counts, k, pseudo, short)
            assert np.array_equal(a.view(np.int64), b.view(np.int64))
            ea = J["probs"].compute_emi_from_pat(a, k)
            eb = T["probs"].compute_emi_from_pat(b, k)
            assert np.array_equal(ea.view(np.int64), eb.view(np.int64))
            la = J["probs"].compute_lower_order_pats(a, k)
            lb = T["probs"].compute_lower_order_pats(b, k)
            assert all(np.array_equal(x.view(np.int64), y.view(np.int64))
                       for x, y in zip(la, lb))


@pytest.mark.parametrize("length,memory,neighbors", [(20, 3, 0), (5, 2, 0),
                                                     (30, 3, 3), (6, 1, 1)])
def test_motif_bit_equal(length, memory, neighbors):
    rng = np.random.default_rng(length * 10 + memory)
    codes = rng.integers(0, 4, size=2000).astype(np.int8)
    codes[rng.random(2000) < 0.01] = 4          # a few N
    motifs = [mod["motif"].Motif(length, memory, pseudocount=1,
                                 neighbors=neighbors) for mod in (J, T)]
    for pos in rng.integers(0, 2000 - length - memory, size=40):
        rev = bool(rng.random() < 0.5)
        w = int(rng.integers(1, 10))
        for m in motifs:
            m.add_sequence(codes, int(pos), weight=w, reverse=rev)
    a, b = motifs
    assert np.array_equal(a.window_counts, b.window_counts)
    for m in motifs:
        m.make_probs()
    assert np.array_equal(a.window_probs.view(np.int64),
                          b.window_probs.view(np.int64))
    la, lb = [], []
    a.write(la)
    b.write(lb)
    assert la == lb


def test_fmt_equal():
    rng = np.random.default_rng(5)
    xs = np.concatenate([rng.random(200) * 10.0 ** rng.integers(
        -12, 8, size=200), [0.0, 1.0, 1e6, 2.65e-05, 0.00266]])
    for p in (3, 4, 6):
        assert [J["fmt"].g(x, p) for x in xs] == [T["fmt"].g(x, p)
                                                  for x in xs]
    assert [J["fmt"].seq_inv(pn, 5) for pn in range(1024)] == \
        [T["fmt"].seq_inv(pn, 5) for pn in range(1024)]


def test_training_refuses_to_fall_back_to_cpu(tmp_path, monkeypatch,
                                              capsys):
    """Without a card run_training, CRFTrainer and etraining's command
    line raise (nothing read or written) unless asked for the CPU."""
    from augustus_tpu_torch.cli import etraining as cli
    from augustus_tpu_torch.predict import Model
    from augustus_tpu_torch.training.crf import CRFTrainer
    from augustus_tpu_torch.training.etraining import run_training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_config(str(tmp_path), "augustus_tpu_torch", "sp")
    gb = os.path.join(DATA, "genes_test1.gb")
    args = train_args(cfg, "sp", gb, CRF="on")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(dict(args))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(dict(args), device="cuda")
    argv = [gb, "--species=sp", f"--AUGUSTUS_CONFIG_PATH={cfg}",
            "--CRF=on"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--device=cuda"])
    assert os.listdir(os.path.join(cfg, "species", "sp")) == [
        "sp_parameters.cfg"]
    # the maximum-likelihood part alone on the CPU
    assert cli.main(argv[:-1] + ["--device=cpu"]) == 0
    assert "sp_exon_probs.pbl" in os.listdir(os.path.join(cfg, "species",
                                                          "sp"))
    model = Model.load({"species": "sp", "AUGUSTUS_CONFIG_PATH": cfg,
                        "UTR": "off", "softmasking": "0"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CRFTrainer(model)
    assert CRFTrainer(model, device="cpu").device == torch.device("cpu")
