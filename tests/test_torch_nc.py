"""ncRNA prediction (--nc=on, 83 states) in the port against augustus_tpu on
the CPU, before any decode: the generated architecture (reproducible, the
UTR architecture's 71 states at their indices, every nc state reachable),
the nc host tracks of prepare_nc bit-equal to augustus_tpu's, the
candidate enumeration nc_cands equal at every nc state of a window around
the hints, the hint fixture's branches, intron hints of one end with two starts
held to augustus_tpu's GoldEngine.run, and the refusals that remain
(sampling and MEA)."""

import os

import numpy as np
import pytest
import torch

from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.model.state_config import ST, is_nc
from augustus_tpu_torch.predict import Model
from torch_nc_check import (CONFIG, HINTS, NC_ARGS, gold_engine, nc_run,
                            port_gold)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
NC_TYPES = [t for t in ST if is_nc(t)]
# the nc host tracks (gold_nc.prepare_nc) and the tracks nc_cands reads
NC_ATTRS = ("log_len_ncsingle", "log_len_ncinternal", "nc_tss_plus",
            "nc_tss_minus", "nc_tts_plus", "nc_tts_minus", "nc_dss_adj_p",
            "nc_dss_adj_m", "nc_ass_adj_p", "nc_ass_adj_m",
            "nc_cumcov_ep_plus", "nc_cumcov_ep_minus", "log_local_malus_ep",
            "ipb_plus", "ipb_minus", "ipb_plus_cum", "ipb_minus_cum")
# positions of nc_cands compared: around nc_hints.gff's transcript, and
# all of HS08198.fa
WINDOWS = {"nc_hints": (8900, 9300), "nc_fixture": (1, None)}


@pytest.fixture(scope="module")
def both():
    return JModel.load(dict(NC_ARGS)), Model.load(dict(NC_ARGS))


def test_fixture_architecture(both):
    """83 states: the 71 of states_shadow_utr.cfg at their indices, then the
    12 nc states of class ncmodel; every state reachable but the UTR
    intronvar states, which the UTR fixture leaves without an incoming edge
    (the nc intronvar states have their 0.1 entries); each transition row
    sums to 1."""
    jm, m = both
    sg = m.sg
    assert sg.statecount == 83
    assert sg.state_types[71:] == NC_TYPES
    assert sg.model_class[71:] == ["ncmodel"] * 12
    utr = Model.load(dict(NC_ARGS, nc="off"))
    assert sg.state_types[:71] == utr.sg.state_types
    utr_var = {ST.utr5intronvar, ST.utr3intronvar, ST.rutr5intronvar,
               ST.rutr3intronvar}
    reach = sg.reachable_states()
    for s, t in enumerate(sg.state_types):
        assert reach[s] == (t not in utr_var), t.name
    rows = sg.transitions.sum(axis=1)
    np.testing.assert_allclose(rows, 1.0, rtol=1e-12)
    assert np.array_equal(sg.transitions, jm.sg.transitions)


def test_fixture_is_reproducible(tmp_path, monkeypatch):
    """The committed nc architecture, extrinsic config and hint fixture are
    what make_nc_fixture.py writes."""
    import importlib.util
    path = os.path.join(ROOT, "augustus_tpu_torch", "data",
                        "make_nc_fixture.py")
    spec = importlib.util.spec_from_file_location("make_nc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dirs = {"MODEL": ("model", ("states_shadow_utr.cfg",
                                "trans_shadow_partial_utr.pbl")),
            "EXTRINSIC": ("extrinsic", ("extrinsic.M.RM.E.W.cfg",)),
            "HINTS": ("hints", ())}
    for attr, (sub, inputs) in dirs.items():
        d = tmp_path / sub
        d.mkdir()
        for f in inputs:
            (d / f).write_text(open(os.path.join(CONFIG, sub, f)).read())
        monkeypatch.setattr(mod, attr, str(d))
    mod.main()
    for sub, f in (("model", "states_shadow_utr_nc.cfg"),
                   ("model", "trans_shadow_partial_utr_nc.pbl"),
                   ("extrinsic", "extrinsic.M.RM.E.W.nc.cfg")):
        assert open(os.path.join(CONFIG, sub, f)).read() == \
            (tmp_path / sub / f).read_text(), f
    assert open(os.path.join(HINTS, "HS08198.nc.gff")).read() == \
        (tmp_path / "hints" / "HS08198.nc.gff").read_text()


def _bits(x):
    a = np.asarray(x)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("which", ["nc_plain", "nc_hints", "nc_fixture"])
def test_prepare_nc_tracks_bit_equal(which):
    """The port's prepare_nc (and the intronpart tracks nc_cands reads) on
    the piece equal augustus_tpu's bit for bit; without hints the
    boundary tracks are empty."""
    ref, got = gold_engine(which, run=False), port_gold(which)
    for name in NC_ATTRS:
        assert hasattr(ref, name) == hasattr(got, name), name
        if hasattr(ref, name):
            assert _bits(getattr(ref, name)) == _bits(getattr(got, name)), \
                name
    if which == "nc_plain":
        assert np.isneginf(got.nc_tss_plus).all()
        assert np.isneginf(got.nc_tts_minus).all()
    else:
        assert np.isfinite(got.nc_tss_plus).any()


@pytest.mark.parametrize("which", ["nc_hints", "nc_fixture"])
def test_nc_cands_equal(which):
    """nc_cands of the port equals augustus_tpu's (weights bit for bit,
    predecessors and ends) at every nc state and position of the window,
    on one random Viterbi table."""
    ref, got = gold_engine(which, run=False), port_gold(which)
    from augustus_tpu.engine import gold_nc as jnc
    from augustus_tpu_torch.engine import gold_nc as pnc
    n, S = got.n, got.S
    table = np.random.default_rng(12).normal(-50.0, 20.0, (n, S))
    lo, hi = WINDOWS[which]
    hi = n if hi is None else min(hi, n)
    live = 0
    for s, t in enumerate(got.sg.state_types):
        if not is_nc(t):
            continue
        for j in range(lo, hi):
            c = int(got.stairs[j])
            a = jnc.nc_cands(ref, j, c, s, t, table)
            b = pnc.nc_cands(got, j, c, s, t, table)
            assert (a is None) == (b is None), (t.name, j)
            if a is None:
                continue
            live += 1
            for x, y in zip(a, b):
                assert _bits(x) == _bits(y), (t.name, j)
    assert live > 0


def _fixture_tracks():
    from augustus_tpu_torch.engine.device import build_tracks
    g = port_gold("nc_fixture")
    return g, build_tracks(g)


def test_fixture_reaches_every_nc_branch():
    """The hint fixture reaches what nc_hints.gff does not: ncintronvar and
    rncintronvar fire (one end from two hints of one start, whose bonuses
    add; a second end of the same start), an exonpart moves a band's first
    begin back past the last 201, dss and ass hints on both strands,
    exonparts that leave bases of an exon uncovered (the local malus, on),
    a reverse-strand transcript's boundary tracks."""
    g, tr = _fixture_tracks()
    types = g.sg.state_types
    pinned = {types[p.state]: p for p in tr.exon_pinned
              if is_nc(types[p.state])}
    assert set(pinned) == {ST.ncintronvar, ST.rncintronvar}
    for p in pinned.values():
        assert (p.eop >= 0).any()
    fwd = pinned[ST.ncintronvar]
    ends = np.flatnonzero(fwd.eop >= 0)
    assert len(ends) >= 2 and len(set(fwd.eop[ends].tolist())) == 1
    introns = [f for f in g.hints.by_type["intron"] if f.strand == "+"]
    same = [f for f in introns if (f.start, f.end) == (introns[0].start,
                                                        introns[0].end)]
    assert len(same) == 2
    widest = max(int(((c.start_max - c.start_min + 1) * c.end_gate).max())
                 for c in tr.exon_conv if types[c.state] in NC_TYPES)
    assert widest > 201
    for kind in ("dss", "ass"):
        assert {f.strand for f in g.hints.by_type[kind]} == {"+", "-"}
    assert g.log_local_malus_ep != 0.0
    eps = [f for f in g.hints.by_type["exonpart"] if f.strand == "+"]
    cov = g.nc_cumcov_ep_plus
    assert any(cov[f.end + 10] - cov[f.start - 10] > 0 for f in eps)
    assert np.isfinite(g.nc_tts_minus).any()
    assert np.isfinite(g.nc_tss_minus).any()


def test_intron_hints_of_one_end_with_two_starts_refused(tmp_path):
    """Two intron hints ending at one splice site with different starts
    give ncintronvar two candidates at one position, which the tracks now
    carry (test_two_starts_decode_held_to_gold); sampling them with
    --nc=on stays refused, naming the cause, as every nc sampling does."""
    args, _ = nc_run("nc_two_starts", str(tmp_path))
    m = Model.load(dict(args))
    assert m.gff_hints is not None
    with pytest.raises(NotImplementedError, match="noncoding transcript"):
        Model.load(dict(args, sample="100"))


def test_two_starts_decode_held_to_gold(tmp_path, monkeypatch):
    """The same two-start input decodes: the tracks keep both candidates of
    the position in hint order, and K2's plain version over them is held
    to augustus_tpu's GoldEngine.run table (values within TOL at every
    live state, nc backpointers where gold's best leads its runner-up)."""
    import torch_nc_check
    from torch_nc_check import TOL, compare, port_scan
    monkeypatch.setattr(torch_nc_check, "MULTI_DIR", str(tmp_path))
    gold = gold_engine("nc_two_starts")
    g, tr, eng = port_scan("nc_two_starts")
    types = g.sg.state_types
    var = next(p for p in tr.exon_pinned if types[p.state] == ST.ncintronvar)
    assert var.x_pos is not None and len(var.x_pos) >= 1
    j = int(var.x_pos[0])
    assert var.x_eop[0] != var.eop[j]
    # the second start wins there, as in gold
    won = j - (int(eng.bp[j, var.state]) & 0xFFFFF)
    assert won == var.x_eop[0] == int(gold.bp_base[j, var.state])
    nc = [s for s, t in enumerate(types) if is_nc(t)]
    worst, live, checked, _ = compare(gold, tr, eng, TOL, nc)
    assert worst <= TOL and checked > 4000


@pytest.mark.parametrize("extra", [{"sample": "100"}, {"mea": "1"}])
def test_nc_sampling_refused(extra):
    """Sampling and MEA with --nc=on stay refused, naming the cause:
    augustus_tpu prints no noncoding transcript to hold the draws to."""
    with pytest.raises(NotImplementedError, match="noncoding transcript"):
        Model.load(dict(NC_ARGS, **extra))
