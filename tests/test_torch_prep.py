"""Host track preparation and packing of the port equal augustus_tpu's, and
the port's torch expand_arrays equals the reference's jnp expansion."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from augustus_tpu import genetics as jgenetics
from augustus_tpu.engine import pallas_pack as jpack
from augustus_tpu.engine.device import build_tracks as jbuild
from augustus_tpu.engine.gold import GoldEngine as JGold
from augustus_tpu.io.fasta import read_fasta
from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch import genetics
from augustus_tpu_torch.convert import pack_from_reference
from augustus_tpu_torch.engine.device import build_tracks
from augustus_tpu_torch.engine.gold import GoldEngine
from augustus_tpu_torch.engine.pack import (PLANE_INPUTS, KERNEL_CONSTANTS,
                                            expand_arrays, pack_tracks,
                                            to_device)
from augustus_tpu_torch.predict import Model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
SEQ = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0] \
    .sequence.lower()[:6000]


def _args(species):
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}


@pytest.fixture(scope="module", params=["repo_fixture", "repo_fixture_gc2"])
def packed(request):
    jm, m = JModel.load(_args(request.param)), Model.load(_args(request.param))
    codes = jgenetics.encode(SEQ)
    assert np.array_equal(codes, genetics.encode(SEQ))
    je = JGold(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode)
    je.prepare(codes)
    e = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    e.prepare(codes)
    jst, jarr = jpack.pack_tracks(jbuild(je))
    st, arr = pack_tracks(build_tracks(e))
    return request.param, (jst, jarr), (st, arr), e


def test_gc_classes(packed):
    species, _, (st, _), e = packed
    switches = int((np.diff(e.stairs) != 0).sum())
    if species.endswith("gc2"):
        assert st.C == 2 and switches >= 1
    else:
        assert st.C == 1 and switches == 0


def test_static_equal(packed):
    _, (jst, _), (st, _), _ = packed
    ref = dataclasses.asdict(jst)
    assert ref["NHW"] == 0 and ref["hint_lm"] is None
    assert all(c["hint"] is None for c in ref["convs"])
    assert ref == dataclasses.asdict(st)
    assert pack_from_reference(dataclasses.asdict(jst), {
        k: v for k, v in packed[1][1].items()})[0] == st


def test_arrays_equal(packed):
    _, (_, jarr), (_, arr), _ = packed
    assert set(arr) <= set(jarr)
    for k, v in arr.items():
        ref = np.asarray(jarr[k])
        assert v.shape == ref.shape and v.dtype == ref.dtype, k
        assert np.array_equal(v, ref), k


def test_expand_arrays_equal(packed):
    _, (jst, jarr), (st, arr), _ = packed
    ref = jpack.expand_arrays(jst, {k: jnp.asarray(v) for k, v in
                                    jarr.items()})
    got = expand_arrays(st, to_device(arr, "cpu"))
    names = {"sp_state": "sp_state", "sp_geo": "sp_geo",
             "sp_convH": "sp_convH", "ip_conv": "ip_conv",
             "ip_misc": "ip_misc", "gcum": "gcum_hbm", "msk": "msk_hbm"}
    assert set(got) == set(names)
    for k, rk in names.items():
        r = np.asarray(ref[rk])
        g = got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert np.array_equal(g.view(np.int32), r.view(np.int32)), k


def test_to_device_keeps_the_compact_arrays(packed):
    _, _, (st, arr), _ = packed
    t = to_device(arr, "cpu")
    assert set(t) == set(PLANE_INPUTS + KERNEL_CONSTANTS)
    for k, v in t.items():
        assert np.array_equal(v.numpy(), arr[k]), k
        assert v.device == torch.device("cpu")
