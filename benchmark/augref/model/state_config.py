"""State-space architecture: state types, topology, transition tables.

The HMM topology is data-driven, parsed from ``config/model/states_*.cfg``
(state index -> model class) and ``trans_*.pbl`` (initial / terminal /
transition probabilities) exactly like the reference (src/namgene.cc:1318
readTransAndInitProbs, include/types.hh:492 StateType).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List

import numpy as np

from ..properties import Properties

NEG_INF = float("-inf")


class ST(IntEnum):
    """All HMM state types (reference include/types.hh:492-512)."""
    igenic = 0
    # forward coding exons
    singleG = 1; initial0 = 2; initial1 = 3; initial2 = 4
    internal0 = 5; internal1 = 6; internal2 = 7; terminal = 8
    # forward introns (5 per frame)
    lessD0 = 9; longdss0 = 10; equalD0 = 11; geometric0 = 12; longass0 = 13
    lessD1 = 14; longdss1 = 15; equalD1 = 16; geometric1 = 17; longass1 = 18
    lessD2 = 19; longdss2 = 20; equalD2 = 21; geometric2 = 22; longass2 = 23
    # forward UTR
    utr5single = 24; utr5init = 25; utr5intron = 26; utr5intronvar = 27
    utr5internal = 28; utr5term = 29
    utr3single = 30; utr3init = 31; utr3intron = 32; utr3intronvar = 33
    utr3internal = 34; utr3term = 35
    # reverse coding exons
    rsingleG = 36; rinitial = 37
    rinternal0 = 38; rinternal1 = 39; rinternal2 = 40
    rterminal0 = 41; rterminal1 = 42; rterminal2 = 43
    # reverse introns
    rlessD0 = 44; rlongdss0 = 45; requalD0 = 46; rgeometric0 = 47; rlongass0 = 48
    rlessD1 = 49; rlongdss1 = 50; requalD1 = 51; rgeometric1 = 52; rlongass1 = 53
    rlessD2 = 54; rlongdss2 = 55; requalD2 = 56; rgeometric2 = 57; rlongass2 = 58
    # reverse UTR
    rutr5single = 59; rutr5init = 60; rutr5intron = 61; rutr5intronvar = 62
    rutr5internal = 63; rutr5term = 64
    rutr3single = 65; rutr3init = 66; rutr3intron = 67; rutr3intronvar = 68
    rutr3internal = 69; rutr3term = 70
    # generic placeholders
    intron_type = 71; rintron_type = 72; exon_type = 73
    # noncoding
    ncsingle = 74; ncinit = 75; ncintron = 76; ncintronvar = 77
    ncinternal = 78; ncterm = 79
    rncsingle = 80; rncinit = 81; rncintron = 82; rncintronvar = 83
    rncinternal = 84; rncterm = 85


# reading frame ("win") per state type (reference src/types.cc:174-188)
STATE_READING_FRAMES = np.array(
    [0,
     0, 0, 1, 2, 0, 1, 2, 0,           # forward exons
     0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,   # forward introns
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,            # forward utr
     2, 2, 0, 1, 2, 0, 1, 2,           # reverse exons
     0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,   # reverse introns
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,            # reverse utr
     0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32)

_IDENTIFIERS = [
    "igenic",
    "single", "initial0", "initial1", "initial2",
    "internal0", "internal1", "internal2", "terminal",
    "lessD0", "longdss0", "equalD0", "geometric0", "longass0",
    "lessD1", "longdss1", "equalD1", "geometric1", "longass1",
    "lessD2", "longdss2", "equalD2", "geometric2", "longass2",
    "utr5single", "utr5init", "utr5intron", "utr5intronvar",
    "utr5internal", "utr5term",
    "utr3single", "utr3init", "utr3intron", "utr3intronvar",
    "utr3internal", "utr3term",
    "rsingle", "rinitial", "rinternal0", "rinternal1", "rinternal2",
    "rterminal0", "rterminal1", "rterminal2",
    "rlessD0", "rlongdss0", "requalD0", "rgeometric0", "rlongass0",
    "rlessD1", "rlongdss1", "requalD1", "rgeometric1", "rlongass1",
    "rlessD2", "rlongdss2", "requalD2", "rgeometric2", "rlongass2",
    "rutr5single", "rutr5init", "rutr5intron", "rutr5intronvar",
    "rutr5internal", "rutr5term",
    "rutr3single", "rutr3init", "rutr3intron", "rutr3intronvar",
    "rutr3internal", "rutr3term",
    "intron", "rintron", "exon",
    "ncsingle", "ncinit", "ncintron", "ncintronvar", "ncinternal", "ncterm",
    "rncsingle", "rncinit", "rncintron", "rncintronvar", "rncinternal",
    "rncterm",
]
IDENTIFIER_TO_TYPE: Dict[str, ST] = {ident: ST(i)
                                     for i, ident in enumerate(_IDENTIFIERS)}


# -- state class predicates (reference include/types.hh:540-620) -------------

def is_on_f_strand(t: ST) -> bool:
    return (ST.igenic <= t <= ST.utr3term) or (ST.ncsingle <= t <= ST.ncterm)


def initial_exon_type(frame: int) -> ST:
    """reference initialExon(int) (types.hh:663)."""
    return (ST.initial0, ST.initial1, ST.initial2)[frame % 3]


def internal_exon_type(frame: int) -> ST:
    return (ST.internal0, ST.internal1, ST.internal2)[frame % 3]


def r_terminal_exon_type(frame: int) -> ST:
    return (ST.rterminal0, ST.rterminal1, ST.rterminal2)[frame % 3]


def r_internal_exon_type(frame: int) -> ST:
    return (ST.rinternal0, ST.rinternal1, ST.rinternal2)[frame % 3]


def is_initial_exon(t: ST) -> bool:
    return t in (ST.initial0, ST.initial1, ST.initial2)


def is_internal_exon(t: ST) -> bool:
    return t in (ST.internal0, ST.internal1, ST.internal2)


def is_r_internal_exon(t: ST) -> bool:
    return t in (ST.rinternal0, ST.rinternal1, ST.rinternal2)


def is_r_terminal_exon(t: ST) -> bool:
    return t in (ST.rterminal0, ST.rterminal1, ST.rterminal2)


def is_first_exon(t: ST) -> bool:
    return is_initial_exon(t) or is_r_terminal_exon(t) or t in (ST.singleG, ST.rsingleG)


def is_last_exon(t: ST) -> bool:
    return t in (ST.terminal, ST.rinitial, ST.singleG, ST.rsingleG)


def is_coding_exon(t: ST) -> bool:
    return (ST.singleG <= t <= ST.terminal) or (ST.rsingleG <= t <= ST.rterminal2)


def is_coding_intron(t: ST) -> bool:
    return (ST.lessD0 <= t <= ST.longass2) or (ST.rlessD0 <= t <= ST.rlongass2)


def is_geometric_intron(t: ST) -> bool:
    return t in (ST.geometric0, ST.geometric1, ST.geometric2,
                 ST.rgeometric0, ST.rgeometric1, ST.rgeometric2)


def is_utr(t: ST) -> bool:
    return (ST.utr5single <= t <= ST.utr3term) or (ST.rutr5single <= t <= ST.rutr3term)


def is_5utr(t: ST) -> bool:
    return (ST.utr5single <= t <= ST.utr5term) or (ST.rutr5single <= t <= ST.rutr5term)


def is_3utr(t: ST) -> bool:
    return (ST.utr3single <= t <= ST.utr3term) or (ST.rutr3single <= t <= ST.rutr3term)


def is_nc(t: ST) -> bool:
    return ST.ncsingle <= t <= ST.rncterm


def is_utr_intron(t: ST) -> bool:
    return t in (ST.utr5intron, ST.utr5intronvar, ST.utr3intron, ST.utr3intronvar,
                 ST.rutr5intron, ST.rutr5intronvar, ST.rutr3intron, ST.rutr3intronvar)


@dataclass
class StateGraph:
    """Parsed HMM topology.

    Probabilities are stored both linear (float64, as parsed) and in log
    space; the DP consumes the log arrays.
    """
    statecount: int
    model_class: List[str]          # per state: igenicmodel/exonmodel/...
    state_types: List[ST]           # per state: the StateType
    init_probs: np.ndarray          # (S,) linear
    term_probs: np.ndarray          # (S,) linear
    transitions: np.ndarray         # (S,S) linear, row = from-state
    synch_state: int = 0
    type_to_index: Dict[ST, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.type_to_index:
            self.type_to_index = {t: i for i, t in enumerate(self.state_types)}

    def reachable_states(self) -> np.ndarray:
        """Forward-reachability from the initial distribution
        (reference src/namgene.cc:1508 computeReachableStates)."""
        reach = self.init_probs > 0.0
        changed = True
        while changed:
            new = reach | ((reach[:, None] & (self.transitions > 0.0)).any(axis=0))
            changed = bool((new != reach).any())
            reach = new
        return reach


def parse_state_config(props: Properties) -> StateGraph:
    """Build the StateGraph from the properties (which already contain the
    parsed states_*.cfg keys) plus the transition .pbl file."""
    statecount = props.get_int("/NAMGene/statecount")
    synch = props.get_int("/NAMGene/SynchState", 0)

    model_class = [props.get_indexed("/NAMGene/state", i)
                   for i in range(statecount)]

    # assign state types: the i-th created state of class X gets /XModel/typeNN
    counters: Dict[str, int] = {}
    prefix_of = {
        "igenicmodel": "/IGenicModel/type",
        "exonmodel": "/ExonModel/type",
        "intronmodel": "/IntronModel/type",
        "utrmodel": "/UtrModel/type",
        "ncmodel": "/NcModel/type",
    }
    state_types: List[ST] = []
    for cls in model_class:
        j = counters.get(cls, 0)
        counters[cls] = j + 1
        ident = props.get_indexed(prefix_of[cls], j)
        state_types.append(IDENTIFIER_TO_TYPE[ident])

    # transition file: species-specific override, else model default
    transfile = props.get("transfile")
    species = props.get("species")
    candidates = [
        os.path.join(props.species_dir(), f"{species}_{transfile}"),
        os.path.join(props.model_dir(), transfile),
    ]
    path = next(p for p in candidates if os.path.exists(p))

    init_probs = np.zeros(statecount)
    term_probs = np.zeros(statecount)
    transitions = np.zeros((statecount, statecount))
    sections: Dict[str, List[str]] = {}
    section = ""
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("["):
                section = line.strip("[]")
                sections[section] = []
                continue
            sections.setdefault(section, []).extend(line.split())

    for name, dest in (("Initial", init_probs), ("Terminal", term_probs)):
        toks = sections.get(name, [])
        # first token = number of entries; then (state, prob) pairs
        for i in range(1, len(toks) - 1, 2):
            dest[int(toks[i])] = float(toks[i + 1])
    toks = sections.get("Transition", [])
    for i in range(0, len(toks) - 2, 3):
        transitions[int(toks[i]), int(toks[i + 1])] = float(toks[i + 2])

    return StateGraph(statecount=statecount,
                      model_class=model_class,
                      state_types=state_types,
                      init_probs=init_probs,
                      term_probs=term_probs,
                      transitions=transitions,
                      synch_state=synch)
