"""The port's host traceback walk against the reference device walk
(make_trace_fn(n, 0)) on the same backpointer planes: packed emits,
final_base, raw_segments and condensed_path all equal."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from augustus_tpu.engine import traceback as jtb
from augustus_tpu.model.state_config import ST as JST
from augustus_tpu_torch.engine import traceback as tb
from augustus_tpu_torch.model.state_config import ST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")

# the 47-state architecture of the fixtures
TYPES_J = [JST(0)] + [JST(t) for t in range(1, 9)] + \
    [JST(t) for t in range(9, 24)] + [JST(t) for t in range(36, 44)] + \
    [JST(t) for t in range(44, 59)]
TYPES = [ST(int(t)) for t in TYPES_J]


def random_plane(seed: int, n: int, S: int = 47):
    """A backpointer plane with long self-loop runs (chain states), short
    self runs and multi-base segments, every off >= 1."""
    rng = np.random.default_rng(seed)
    off = rng.integers(1, 40, size=(n, 64))
    off = np.minimum(off, np.arange(n)[:, None].clip(min=1))
    pred = rng.integers(0, S, size=(n, 64))
    selfloop = rng.random((n, 64)) < 0.9
    lanes = np.broadcast_to(np.arange(64), (n, 64))
    pred = np.where(selfloop, lanes, pred)
    off = np.where(selfloop, 1, off)
    bp = ((pred << 20) | off).astype(np.int32)
    bp[0] = 0
    return bp


def reference_walk(bp, state0, n):
    fn = jtb.make_trace_fn(n, 0)
    packed, fb = fn(jnp.asarray(bp), state0)
    return np.asarray(packed), int(fb)


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 700), (2, 3000),
                                    (3, 2)])
def test_walk_equal_on_random_planes(seed, n):
    bp = random_plane(seed, n)
    state0 = seed % 47
    ref, ref_fb = reference_walk(bp, state0, n)
    got, fb = tb.trace_packed(bp, state0, n)
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    assert fb == ref_fb


@pytest.mark.parametrize("seed", [4, 5])
def test_segments_and_condensed_path_equal(seed):
    n = 2000
    bp = random_plane(seed, n)
    packed, fb = tb.trace_packed(bp, 0, n)
    ref = jtb.raw_segments(packed, fb, TYPES_J)
    got = tb.raw_segments(packed, fb, TYPES)
    assert [(b, e, int(t)) for b, e, t in got] == \
        [(b, e, int(t)) for b, e, t in ref]
    refc = jtb.condensed_path(packed, fb, n, TYPES_J)
    gotc = tb.condensed_path(packed, fb, n, TYPES)
    assert [(s.begin, s.end, int(s.type), s.truncated) for s in gotc] == \
        [(s.begin, s.end, int(s.type), s.truncated) for s in refc]


def test_walk_on_a_decoded_plane():
    """The plane of a real decode (the reference scan's backpointers in the
    kernel layout) walks the same in both packages."""
    import jax
    from augustus_tpu import genetics
    from augustus_tpu.engine.device import build_tracks
    from augustus_tpu.engine.gold import GoldEngine
    from augustus_tpu.engine.scan import make_scan_fn, split_tracks
    from augustus_tpu.io.fasta import read_fasta
    from augustus_tpu.predict import Model
    m = Model.load({"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0"})
    seq = read_fasta(os.path.join(ROOT, "tests", "data", "HS08198.fa"))[0]
    codes = genetics.encode(seq.sequence.lower())
    eng = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    eng.prepare(codes)
    tr = build_tracks(eng)
    st, arr = split_tracks(tr)
    vfin, bps = jax.jit(make_scan_fn(st))(
        jax.tree_util.tree_map(jnp.asarray, arr), jnp.asarray(tr.log_init))
    n = st.n
    plane = np.zeros((n, 64), np.int32)
    plane[1:, : st.S] = np.asarray(bps)
    state0 = int(np.argmax(np.asarray(vfin) + tr.log_term))
    ref, ref_fb = reference_walk(plane, state0, n)
    got, fb = tb.trace_packed(plane, state0, n)
    assert np.array_equal(got, ref) and fb == ref_fb
    assert (got >> tb.FLAG_BIT).sum() > 100


def test_invalid_backpointer_raises():
    bp = np.zeros((10, 64), np.int32)
    with pytest.raises(RuntimeError, match="invalid backpointer"):
        tb.trace_packed(bp, 0, 10)
