"""Both in-repo species fixtures load the same in augustus_tpu and in the
PyTorch port, and convert.model_from_reference carries a model across."""

import dataclasses
import os

import numpy as np
import pytest

from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.convert import model_from_reference
from augustus_tpu_torch.predict import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
SPECIES = ["repo_fixture", "repo_fixture_gc2"]


def _args(species):
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}


def reference_fields(jm):
    """Plain-data fields of a reference Model (state types as ints)."""
    sg = dataclasses.asdict(jm.sg)
    sg["state_types"] = [int(t) for t in jm.sg.state_types]
    sg.pop("type_to_index")
    return {"props": {"config_path": jm.props.config_path,
                      "store": dict(jm.props.store)},
            "cn": dataclasses.asdict(jm.cn), "sg": sg,
            "igp": dataclasses.asdict(jm.igp),
            "exp": dataclasses.asdict(jm.exp),
            "inp": dataclasses.asdict(jm.inp),
            "decomp": dataclasses.asdict(jm.decomp),
            "gcode": {"table": jm.gcode.table}}


def assert_tree_equal(a, b, path="model"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture(scope="module", params=SPECIES)
def both(request):
    return (JModel.load(_args(request.param)),
            Model.load(_args(request.param)), request.param)


def test_state_graph_equal(both):
    jm, m, _ = both
    assert m.sg.statecount == jm.sg.statecount == 47
    assert [int(t) for t in m.sg.state_types] == \
        [int(t) for t in jm.sg.state_types]
    assert m.sg.model_class == jm.sg.model_class
    for k in ("init_probs", "term_probs", "transitions"):
        assert np.array_equal(getattr(m.sg, k), getattr(jm.sg, k)), k
    assert m.sg.reachable_states().all()
    assert abs(m.sg.transitions.sum(axis=1) - 1).max() < 1e-9
    assert m.sg.init_probs.sum() == pytest.approx(1.0, abs=1e-6)


def test_parameters_equal(both):
    jm, m, species = both
    n_classes = 2 if species.endswith("gc2") else 1
    assert m.decomp.n_classes == jm.decomp.n_classes == n_classes
    assert len(m.inp.gc) == len(m.exp.gc) == len(m.igp.gc) == n_classes
    fj, fp = reference_fields(jm), reference_fields(m)
    for k in ("cn", "igp", "exp", "inp", "decomp", "gcode", "props"):
        assert_tree_equal(fj[k], fp[k], k)


def test_model_from_reference_round_trip(both):
    jm, m, _ = both
    got = model_from_reference(reference_fields(jm))
    assert_tree_equal(reference_fields(got), reference_fields(m))
    assert got.sg.type_to_index == m.sg.type_to_index


def test_gc2_fixture_is_reproducible(tmp_path, monkeypatch):
    """The committed gc2 files are what make_gc2_fixture.py writes."""
    import importlib.util
    path = os.path.join(ROOT, "augustus_tpu_torch", "data",
                        "make_gc2_fixture.py")
    spec = importlib.util.spec_from_file_location("make_gc2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DST", str(tmp_path))
    mod.main()
    committed = os.path.join(CONFIG, "species", "repo_fixture_gc2")
    for f in sorted(os.listdir(committed)):
        assert open(os.path.join(committed, f)).read() == \
            open(tmp_path / f).read(), f
