"""The port's event walk K4 (plain version) against augustus_tpu's
make_event_trace_fn on the same backpointer planes: events, count and final
base equal; the condensed path from the events equal to the port's
condensed_path of the per-base host walk; a walk longer than its bound
continues from where each step stopped."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from augustus_tpu.engine import traceback as jtb
from augustus_tpu.model.state_config import ST as JST
from augustus_tpu_torch.engine import traceback as tb
from augustus_tpu_torch.model.state_config import ST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
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


def _walks(bp: np.ndarray, state0: int, n: int, M: int):
    ref_ev, ref_fb, ref_cnt = jtb.make_event_trace_fn(n, 0, M)(
        jnp.asarray(bp), state0)
    t = torch.from_numpy(bp)
    ev, fb, _, cnt = tb.event_walk_reference(t, tb.walk_breaks(t, n),
                                             state0, n, M)
    return (np.asarray(ref_ev), int(ref_fb), int(ref_cnt)), \
        (ev.numpy(), fb, cnt)


@pytest.fixture(scope="module")
def decoded():
    """The plain Viterbi's plane of the first 7,200 bases of HS04636.fa (two
    genes), its start state and the state types."""
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_planes
    m = Model.load({"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                    "UTR": "off", "softmasking": "0"})
    rec = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0]
    st, planes, gold = piece_planes(m, rec, 7200, "cpu")
    bp, vfin, _ = viterbi_forward(st, planes)
    last = vfin[: st.S].numpy() + np.asarray(gold.log_term[: st.S],
                                             dtype=np.float32)
    return bp, int(np.argmax(last)), st.n, m.sg.state_types


def test_event_walk_equal_on_a_decoded_plane(decoded):
    bp, state0, n, _ = decoded
    (ref_ev, ref_fb, ref_cnt), (ev, fb, cnt) = _walks(bp.numpy(), state0, n,
                                                      tb.M_EVENTS)
    assert 5 < cnt < tb.M_EVENTS
    assert (cnt, fb) == (ref_cnt, ref_fb)
    assert ev.dtype == np.int32 and np.array_equal(ev, ref_ev)


@pytest.mark.parametrize("seed,n,M", [(0, 50, 64), (1, 700, 16384),
                                      (2, 3000, 16384), (3, 2, 8),
                                      (4, 3000, 40)])
def test_event_walk_equal_on_random_planes(seed, n, M):
    """M = 40 on 3,000 bases reaches the bound (count == M)."""
    bp = random_plane(seed, n)
    state0 = seed % 47
    (ref_ev, ref_fb, ref_cnt), (ev, fb, cnt) = _walks(bp, state0, n, M)
    assert (cnt, fb) == (ref_cnt, ref_fb)
    assert np.array_equal(ev, ref_ev)
    if seed == 4:
        assert cnt == M


def test_condensed_path_events_equal_to_the_host_walk(decoded):
    bp, state0, n, types = decoded
    ev, fb, cnt = tb.event_walk(bp, state0, n)
    got = tb.condensed_path_events(ev, cnt, fb, n, types)
    packed, pfb = tb.trace_packed(bp.numpy(), state0, n)
    ref = tb.condensed_path(packed, pfb, n, types)
    assert len(got) > 3
    assert [(s.begin, s.end, int(s.type), s.truncated) for s in got] == \
        [(s.begin, s.end, int(s.type), s.truncated) for s in ref]


@pytest.mark.parametrize("seed", [5, 6])
def test_condensed_path_events_equal_to_the_reference(seed):
    n = 2000
    bp = random_plane(seed, n)
    ev, fb, cnt = tb.event_walk(torch.from_numpy(bp), 0, n)
    ref = jtb.condensed_path_events(ev, cnt, fb, n, TYPES_J)
    got = tb.condensed_path_events(ev, cnt, fb, n, TYPES)
    assert [(s.begin, s.end, int(s.type), s.truncated) for s in got] == \
        [(s.begin, s.end, int(s.type), s.truncated) for s in ref]


@pytest.mark.parametrize("M", [1, 3, 5])
def test_event_walk_past_its_bound(decoded, M):
    """A walk of more events than the bound M runs in steps of M events,
    each from the base and state where the last stopped: the same events,
    count and final base as one unbounded walk, and the same path as the
    per-base host walk."""
    bp, state0, n, types = decoded
    ev, fb, cnt = tb.event_walk(bp, state0, n, M)
    ref_ev, ref_fb, ref_cnt = tb.event_walk(bp, state0, n, n)
    assert cnt > 2 * M and (cnt, fb) == (ref_cnt, ref_fb)
    assert np.array_equal(ev, ref_ev)
    packed, pfb = tb.trace_packed(bp.numpy(), state0, n)
    ref = tb.condensed_path(packed, pfb, n, types)
    got = tb.condensed_path_events(ev, cnt, fb, n, types)
    assert [(s.begin, s.end, int(s.type), s.truncated) for s in got] == \
        [(s.begin, s.end, int(s.type), s.truncated) for s in ref]


def test_event_walk_checks_its_plane():
    """A plane of any width walks (K2's are 47-83 wide); a start state
    outside the plane, a plane that is not (n, W) int32 and a backpointer
    that never moves the walk (off 0) are refused."""
    with pytest.raises(ValueError):
        tb.event_walk(torch.zeros((10, 32), dtype=torch.int32), 32, 10)
    with pytest.raises(ValueError):
        tb.event_walk(torch.zeros((10, 32), dtype=torch.float32), 0, 10)
    with pytest.raises(ValueError):
        tb.event_walk(torch.zeros((9, 32), dtype=torch.int32), 0, 10)
    with pytest.raises(RuntimeError):
        tb.event_walk(torch.zeros((10, 32), dtype=torch.int32), 0, 10)
