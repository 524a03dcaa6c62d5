"""The event walk K4 at the widths of K2's planes: its plain version on the
(n, 71) plane of a UTR piece and the (n, 83) plane of an ncRNA piece
(K2's plain version) against augustus_tpu's make_event_trace_fn (events,
count, final base) and make_trace_fn (the per-base walk of its host route:
the port's numpy walk gives the same emits, and the condensed path from
the events equals the one from those emits); the engines' traceback_path
walks by events."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from augustus_tpu.engine import traceback as jtb
from augustus_tpu_torch.engine import traceback as tb
from augustus_tpu_torch.engine.scan import scan_forward
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, piece_scan

from torch_pieces import CONFIG, DATA

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)


def _plane(which: str):
    """K2's plane of all of HS04636.fa as a UTR (71 states, a gene) or
    nc piece (83 states with nc_hints.gff, a noncoding transcript), its
    walk start (the argmax of v_final + log_term) and the state types."""
    if which == "utr":
        args = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
                "UTR": "on", "softmasking": "0"}
        fasta = os.path.join(DATA, "HS04636.fa")
    else:
        from torch_nc_check import nc_run
        args, fasta = nc_run("nc_hints")
    model = Model.load(args)
    st, t, v0, gold = piece_scan(model, read_fasta(fasta)[0], None, "cpu")
    bp, vfin, _ = scan_forward(st, t, v0)
    last = vfin.numpy() + np.asarray(gold.log_term)
    return bp, int(np.argmax(last)), st.n, model.sg.state_types


@pytest.fixture(scope="module", params=["utr", "nc"])
def plane(request):
    return _plane(request.param)


def test_plane_widths(plane):
    bp, _, n, types = plane
    assert bp.shape == (n, len(types)) and bp.shape[1] in (71, 83)


def test_event_walk_equal_to_make_event_trace_fn(plane):
    bp, state0, n, _ = plane
    ref_ev, ref_fb, ref_cnt = jtb.make_event_trace_fn(n, 0, tb.M_EVENTS)(
        jnp.asarray(bp.numpy()), state0)
    ev, fb, cnt = tb.event_walk(bp, state0, n)
    assert cnt >= 3 and (cnt, fb) == (int(ref_cnt), int(ref_fb))
    assert np.array_equal(ev, np.asarray(ref_ev)[:cnt])


def test_event_path_equal_to_make_trace_fn(plane):
    """The per-base walk of augustus_tpu's host route and the port's numpy
    walk give the same emits; the path from the events equals the path
    from those emits (augustus_tpu's condensed_path)."""
    from augustus_tpu.model.state_config import ST as JST
    bp, state0, n, types = plane
    packed, fb = jtb.make_trace_fn(n, 0)(jnp.asarray(bp.numpy()), state0)
    packed = np.asarray(packed)
    ppacked, pfb = tb.trace_packed(bp.numpy(), state0, n)
    assert int(fb) == pfb and np.array_equal(packed, ppacked)
    jtypes = [JST(int(t)) for t in types]
    want = jtb.condensed_path(packed, int(fb), n, jtypes)
    ev, efb, cnt = tb.event_walk(bp, state0, n)
    got = tb.condensed_path_events(ev, cnt, efb, n, types)
    assert len(got) >= 3
    assert [(s.begin, s.end, int(s.type), s.truncated) for s in got] == \
        [(s.begin, s.end, int(s.type), s.truncated) for s in want]


def test_walk_past_its_bound_at_this_width(plane):
    bp, state0, n, _ = plane
    ev, fb, cnt = tb.event_walk(bp, state0, n, 1)
    ref_ev, ref_fb, ref_cnt = tb.event_walk(bp, state0, n)
    assert cnt >= 3 and (fb, cnt) == (ref_fb, ref_cnt)
    assert np.array_equal(ev, ref_ev)
