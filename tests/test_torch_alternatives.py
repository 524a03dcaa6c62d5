"""hints/alternatives.py of the port against augustus_tpu's, function by
function, on hint groups parsed by each package with the port's
extrinsic.M.RM.E.W.cfg: two incompatible intron groups of equal priority,
a group that a higher-priority incompatible group overrules, a group weaker
than a stronger one, and the EST hint groups of HS04636sm.E.gff; the runs
of create_prediction_scheme with their padded intervals snapped to 10."""

import os

import numpy as np
import pytest

from augustus_tpu import genetics as jgenetics
from augustus_tpu.hints import alternatives as jalt
from augustus_tpu.hints import config as jconfig
from augustus_tpu.hints import system as jsystem
from augustus_tpu_torch import genetics
from augustus_tpu_torch.hints import alternatives as alt
from augustus_tpu_torch.hints import config as hconfig
from augustus_tpu_torch.hints import system as hsystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DATA = os.path.join(ROOT, "augustus_tpu_torch", "data")
CFG = os.path.join(PKG_DATA, "config", "extrinsic", "extrinsic.M.RM.E.W.cfg")
SEQLEN = 12000

# (case, hint lines, expected number of runs)
CASES = {
    # two intron groups of equal priority sharing a donor: incompatible,
    # neither overrules the other, so each gets a run without the other
    "equal_priority": ([
        "chr1\tm\tintron\t583\t811\t0\t+\t.\tgrp=A;pri=4;src=M",
        "chr1\tm\tintron\t583\t1052\t0\t+\t.\tgrp=B;pri=4;src=M"], 2),
    # the same with A of a higher priority: B is overruled
    "overruled": ([
        "chr1\tm\tintron\t583\t811\t0\t+\t.\tgrp=A;pri=5;src=M",
        "chr1\tm\tintron\t583\t1052\t0\t+\t.\tgrp=B;pri=4;src=M"], 1),
    # C's one intron is part of D, compatible and weaker; E on the other
    # strand is incompatible with both; F far away stands alone
    "weaker_and_strands": ([
        "chr1\tm\tintron\t2001\t2300\t0\t+\t.\tgrp=C;pri=4;src=M",
        "chr1\tm\tintron\t2001\t2300\t0\t+\t.\tgrp=D;pri=4;src=M",
        "chr1\tm\tintron\t2501\t2800\t0\t+\t.\tgrp=D;pri=4;src=M",
        "chr1\tm\tintron\t2101\t2400\t0\t-\t.\tgrp=E;pri=4;src=M",
        "chr1\tm\tstart\t9001\t9003\t0\t+\t.\tgrp=F;pri=3;src=M",
        "chr1\tm\tintron\t9301\t9600\t0\t+\t.\tgrp=F;pri=3;src=M"], None),
}


class _AltGene:
    """The two methods of an AltGene that create_prediction_scheme reads."""

    def __init__(self, begin, end):
        self.begin, self.end = begin, end

    def min_trans_begin(self):
        return self.begin

    def max_trans_end(self):
        return self.end


def _seq_hints(lines, path, seqname):
    """SeqHints of both packages over the same hint file: (port, reference)."""
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("acgt"), SEQLEN))
    out = []
    for cfgmod, sysmod, gen in ((hconfig, hsystem, genetics),
                                (jconfig, jsystem, jgenetics)):
        cfg = cfgmod.read_extrinsic_cfg(CFG)
        feats = sysmod.parse_gff_hints(path, cfg)[seqname]
        out.append(sysmod.SeqHints(feats, cfg, gen.encode(seq)))
    return out


@pytest.fixture(scope="module", params=sorted(CASES) + ["HS04636sm_E"])
def hints(request, tmp_path_factory):
    """(case, port SeqHints, reference SeqHints, expected runs or None)."""
    if request.param == "HS04636sm_E":
        path = os.path.join(PKG_DATA, "hints", "HS04636sm.E.gff")
        return request.param, *_seq_hints(None, path, "HS04636sm"), None
    lines, runs = CASES[request.param]
    path = tmp_path_factory.mktemp("alt") / f"{request.param}.gff"
    path.write_text("\n".join(lines) + "\n")
    return request.param, *_seq_hints(lines, str(path), "chr1"), runs


def _index(groups):
    return {id(g): i for i, g in enumerate(groups)}


def _named(idx, lst):
    return [idx[id(g)] for g in lst]


def test_groups_equal(hints):
    _, sh, jsh, _ = hints
    assert len(sh.groups) == len(jsh.groups) > 1
    for g, j in zip(sh.groups, jsh.groups):
        assert (g.name, g.begin, g.end, g.priority) == \
            (j.name, j.begin, j.end, j.priority)
        assert alt.can_cause_alt_splice(g) == jalt.can_cause_alt_splice(j)


def test_group_compatible_equal(hints):
    _, sh, jsh, _ = hints
    pairs = [(a, b) for a in range(len(sh.groups))
             for b in range(len(sh.groups)) if a != b]
    got = [alt.group_compatible(sh.groups[a], sh.groups[b]) for a, b in pairs]
    want = [jalt.group_compatible(jsh.groups[a], jsh.groups[b])
            for a, b in pairs]
    assert got == want


def test_inter_group_relations_equal(hints):
    case, sh, jsh, _ = hints
    idx, jidx = _index(sh.groups), _index(jsh.groups)
    incomp, stronger = alt.inter_group_relations(sh.groups)
    jincomp, jstronger = jalt.inter_group_relations(jsh.groups)
    for g, j in zip(sh.groups, jsh.groups):
        assert _named(idx, incomp[id(g)]) == _named(jidx, jincomp[id(j)])
        assert _named(idx, stronger[id(g)]) == _named(jidx, jstronger[id(j)])
    if case == "equal_priority":
        a, b = sh.groups
        assert incomp[id(a)] == [b] and incomp[id(b)] == [a]
    if case == "weaker_and_strands":
        assert any(stronger[id(g)] for g in sh.groups)


@pytest.mark.parametrize("genes", [[], [(300, 1500), (1900, 3000)]])
def test_prediction_scheme_equal(hints, genes):
    """The runs (interval and omitted groups) and each run's causing
    groups; with genes, the intervals grow to cover the genes they cut."""
    case, sh, jsh, expected = hints
    idx, jidx = _index(sh.groups), _index(jsh.groups)
    ags = [_AltGene(b, e) for b, e in genes]
    runs = alt.create_prediction_scheme(sh, ags, SEQLEN)
    jruns = jalt.create_prediction_scheme(jsh, ags, SEQLEN)
    assert [(r.begin, r.end, _named(idx, r.omitted)) for r in runs] == \
        [(r.begin, r.end, _named(jidx, r.omitted)) for r in jruns]
    if expected is not None:
        assert len(runs) == expected
    for r in runs:
        assert r.begin % 10 == 0 and 0 <= r.begin <= r.end <= SEQLEN - 1
    if case == "overruled":
        assert _named(idx, runs[0].omitted) == [1]     # B left out
    incomp, stronger = alt.inter_group_relations(sh.groups)
    jincomp, jstronger = jalt.inter_group_relations(jsh.groups)
    for r, j in zip(runs, jruns):
        assert _named(idx, alt.causing_groups(r, incomp, stronger,
                                              sh.groups)) == \
            _named(jidx, jalt.causing_groups(j, jincomp, jstronger,
                                             jsh.groups))
    every = alt.PredictionRun(0, SEQLEN - 1, None, all_hints=True)
    assert alt.causing_groups(every, incomp, stronger, sh.groups) == \
        sh.groups
