"""The PyTorch/CUDA port imports neither JAX nor the JAX package, runs on
CUDA unless asked otherwise, and chip_smoke.py refuses to run without a
card or outside a checkout."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "augustus_tpu_torch")
CONFIG = os.path.join(PKG, "data", "config")
FASTA = os.path.join(ROOT, "tests", "data", "HS08198.fa")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                mods.append(mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "augustus_tpu"


def test_no_jax_in_sys_modules_after_import():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'augustus_tpu'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert {"augustus_tpu_torch.engine.viterbi",
            "augustus_tpu_torch.hints.config",
            "augustus_tpu_torch.hints.features",
            "augustus_tpu_torch.hints.system",
            "augustus_tpu_torch.output.evidence",
            "augustus_tpu_torch.parallel",
            "augustus_tpu_torch.parallel.mesh",
            "augustus_tpu_torch.parallel.distributed",
            "augustus_tpu_torch.pipeline.optimize",
            "augustus_tpu_torch.ppx.fastblock",
            "augustus_tpu_torch.cli.bam2hints",
            "augustus_tpu_torch.cli.fastBlockSearch",
            "augustus_tpu_torch.cli.pp_simScore",
            "augustus_tpu_torch.cli.prepareAlign",
            "augustus_tpu_torch.cli.getSeq",
            "augustus_tpu_torch.cli.load2db",
            "augustus_tpu_torch.cli.load2sqlitedb",
            "augustus_tpu_torch.cgp",
            "augustus_tpu_torch.cgp.alignment",
            "augustus_tpu_torch.cgp.codonevo",
            "augustus_tpu_torch.cgp.compgenepred",
            "augustus_tpu_torch.cgp.exoncand",
            "augustus_tpu_torch.cgp.helpers",
            "augustus_tpu_torch.cgp.mysql_db",
            "augustus_tpu_torch.cgp.orthoexon",
            "augustus_tpu_torch.cgp.orthograph",
            "augustus_tpu_torch.cgp.phylo",
            "augustus_tpu_torch.cgp.seq_access",
            "augustus_tpu_torch.cgp.speciesgraph",
            "augustus_tpu_torch.cgp.sqlite_db",
            "augustus_tpu_torch.cgp.train_logreg"} <= set(_port_modules())


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]))
def test_sources_import_no_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path} imports {name}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from augustus_tpu_torch.predict import Model, predict_file, \
        resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model.load({"species": "repo_fixture",
                        "AUGUSTUS_CONFIG_PATH": CONFIG, "UTR": "off",
                        "softmasking": "0"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_file(model, FASTA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("args", [
    {"nc": "on", "UTR": "on", "sample": "100",
     "alternatives-from-sampling": "1"},
    {"nc": "1", "sample": "10"}, {"nc": "true", "mea": "on"},
    {"nc": "on", "mea": "1", "sample": "100",
     "alternatives-from-sampling": "1"},
    {"nc": "on", "UTR": "on", "mea": "1"}])
def test_out_of_slice_requests_raise(args):
    from augustus_tpu_torch.predict import Model
    a = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
         "UTR": "off", "softmasking": "0"}
    a.update(args)
    with pytest.raises(NotImplementedError):
        Model.load(a)


def _run_smoke(cwd, script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=120)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
