"""Maximum-expected-accuracy decoding over sampled transcripts.

Port of `augustus_tpu/output/mea.py` (numpy and Python only; the sampled
transcripts come from the forward-table kernel and the host walk).

Behavioral equivalent of the reference MEA subsystem (src/mea.cc,
src/graph.cc, src/meaPath.cc): sampled transcripts become a Status list, an
AugustusGraph DAG is built (exon nodes, neutral intergenic line, compatible
and back edges), scores are a piecewise-linear transform of posterior
probabilities (/MeaPrediction/* parameters), and the best transcript set is
the longest path (iterated Bellman relaxation over a DFS postorder).

Node/edge scores are float32 as in the reference (include/graph.hh:141-176);
container iteration orders replicate libstdc++ std::list::sort semantics so
ties resolve identically.  The UTR branches are kept for the UTR models,
which the port does not load yet.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional

import numpy as np

from .. import genetics
from ..model.state_config import (ST, is_coding_exon, is_initial_exon,
                                  is_r_terminal_exon)
from . import genes as og

f32 = np.float32

# Statename enum (include/graph.hh:27)
CDS, UTR3, UTR5, INTRON, UTR3INTRON, UTR5INTRON = 0, 1, 2, 3, 4, 5

NEG_INF32 = f32("-inf")


class Status:
    __slots__ = ("name", "begin", "end", "score", "next", "item")

    def __init__(self, name, begin, end, score, item):
        self.name = name
        self.begin = begin
        self.end = end
        self.score = float(score)
        self.next: Optional["Status"] = None
        self.item = item          # og.PathState


class Node:
    __slots__ = ("begin", "end", "score", "item", "n_type", "pred", "edges",
                 "_id")

    def __init__(self, begin, end, score=0.0, item=None, n_type="unknown"):
        self.begin = begin
        self.end = end
        self.score = f32(score)
        self.item = item
        self.n_type = n_type       # "IR" | "sampled" | "head" | "tail"
        self.pred: Optional["Node"] = None
        self.edges: List["Edge"] = []


class Edge:
    __slots__ = ("to", "score", "neutral", "item")

    def __init__(self, to, neutral=True, score=0.0, item=None):
        self.to = to
        self.score = f32(score)
        self.neutral = neutral
        self.item = item


# ---------------------------------------------------------------------------
# libstdc++ std::list::sort replica (stable mergesort via 64 bins); needed
# because the reference comparators (compareNodes/compareEdges) are
# non-strict (<=), which flips tie order relative to a stable sort.
# ---------------------------------------------------------------------------

def _merge(this: list, x: list, comp) -> list:
    out = []
    i = j = 0
    while i < len(this) and j < len(x):
        if comp(x[j], this[i]):
            out.append(x[j])
            j += 1
        else:
            out.append(this[i])
            i += 1
    out.extend(this[i:])
    out.extend(x[j:])
    return out


def list_sort(lst: list, comp) -> list:
    if len(lst) <= 1:
        return list(lst)
    tmp: List[list] = []
    fill = 0
    pos = 0
    while pos < len(lst):
        carry = [lst[pos]]
        pos += 1
        counter = 0
        while counter < fill and tmp[counter]:
            carry = _merge(tmp[counter], carry, comp)
            tmp[counter] = []
            counter += 1
        if counter == len(tmp):
            tmp.append([])
        tmp[counter] = carry
        if counter == fill:
            fill += 1
    for counter in range(1, fill):
        tmp[counter] = _merge(tmp[counter], tmp[counter - 1], comp)
    return tmp[fill - 1]


# ---------------------------------------------------------------------------
# Status list construction (reference buildStatusList, mea.cc:115)
# ---------------------------------------------------------------------------

def build_status_list(transcripts: List[og.Gene], utr: bool) -> List[Status]:
    stlist: List[Status] = []
    for tx in transcripts:
        states: List[Status] = []
        _add_to_list(tx.exons, CDS, states)
        _add_to_list(tx.introns, INTRON, states)
        if utr:
            _add_to_list(tx.utr5exons, UTR5, states)
            _add_to_list(tx.utr3exons, UTR3, states)
            _add_to_list(tx.utr5introns, UTR5INTRON, states)
            _add_to_list(tx.utr3introns, UTR3INTRON, states)
        states.sort(key=lambda s: (s.begin, s.end))   # compareStatus, stable
        for a, b in zip(states, states[1:]):
            a.next = b
        if states:
            states[-1].next = None
        stlist.extend(states)
    return stlist


def _add_to_list(states, name, out: List[Status]) -> None:
    for st in states:
        if st.end >= st.begin:
            out.append(Status(name, st.begin, st.end, st.apostprob, st))


# ---------------------------------------------------------------------------
# AugustusGraph
# ---------------------------------------------------------------------------

class MeaParams:
    def __init__(self, props):
        g = props.get_float
        self.alpha_e = g("/MeaPrediction/alpha_E", 1.0)
        self.alpha_i = g("/MeaPrediction/alpha_I", 1.0)
        self.x0_e = g("/MeaPrediction/x0_E", -10.0)
        self.x0_i = g("/MeaPrediction/x0_I", -10.0)
        self.x1_e = g("/MeaPrediction/x1_E", 10.0)
        self.x1_i = g("/MeaPrediction/x1_I", 10.0)
        self.y0_e = g("/MeaPrediction/y0_E", 0.5)
        self.y0_i = g("/MeaPrediction/y0_I", 0.5)
        self.i1_e = g("/MeaPrediction/i1_E", 0.25)
        self.i1_i = g("/MeaPrediction/i1_I", 0.25)
        self.i2_e = g("/MeaPrediction/i2_E", 0.75)
        self.i2_i = g("/MeaPrediction/i2_I", 0.75)
        self.j1_e = g("/MeaPrediction/j1_E", -5.0)
        self.j1_i = g("/MeaPrediction/j1_I", -5.0)
        self.j2_e = g("/MeaPrediction/j2_E", 5.0)
        self.j2_i = g("/MeaPrediction/j2_I", 5.0)
        self.no_compatible_edges = props.get_bool(
            "/MeaPrediction/no_compatible_edges", False)
        # logistic-regression scoring (reference Constant::logreg defaults
        # to TRUE with all-zero weights, types.cc:340-374 -- making every
        # node/edge score 0 unless lg_exon_score*/intron_score* are set)
        self.logreg = props.get_bool("/CompPred/logreg", True)
        self.lg_es = [props.get_float("lg_exon_score%d" % i, 0.0)
                      for i in range(4)]
        self.in_sc = [props.get_float("/CompPred/intron_score%d" % i, 0.0)
                      for i in range(4)]


class AugustusGraph:
    def __init__(self, statelist: List[Status], codes: np.ndarray,
                 params: MeaParams, utr: bool, gcode):
        self.statelist = statelist
        self.codes = codes
        self.seqlength = codes.shape[0]
        self.p = params
        self.utr = utr
        self.gcode = gcode
        self.nodelist: List[Node] = []
        self.hash: Dict[str, Node] = {}
        self.base_score = np.zeros(10 * self.seqlength, dtype=np.float64)

    # -- keys ---------------------------------------------------------------
    def key_node(self, n: Node) -> str:
        if n.item is None:
            return "%d:neutral" % n.begin
        return "%d:%d:%d" % (n.begin, n.end, int(n.item.type))

    def key_status(self, st: Status) -> str:
        return "%d:%d:%d" % (st.begin, st.end, int(st.item.type))

    # -- construction -------------------------------------------------------
    def build(self) -> None:
        self._get_size_neutral_line()
        neutral_line: List[Optional[Node]] = \
            [None] * (self.max - self.min + 1)
        self.head = Node(-1, -1, n_type="head")
        self.nodelist.append(self.head)
        self.tail = Node(self.max + 1, self.max + 1, n_type="tail")
        self.nodelist.append(self.tail)
        self._calculate_base_scores()

        for i, st in enumerate(self.statelist):
            if st.name in (CDS, UTR3, UTR5):
                if st.next is not None:
                    if st.next.name in (CDS, UTR3, UTR5):
                        self._add_pair(st, st.next, neutral_line)
                    else:
                        if st.next.next is not None:
                            self._add_pair(st, st.next.next, neutral_line)
                        else:
                            self._add_exon(st, neutral_line)
                            self._add_edge_to_tail(st)
                else:
                    self._add_exon(st, neutral_line)
                    self._add_edge_to_tail(st)
        self._create_neutral_line(neutral_line)

        self._add_edge_from_head(self.statelist[0])
        for i, st in enumerate(self.statelist):
            if st.next is None and i + 1 < len(self.statelist):
                self._add_edge_from_head(self.statelist[i + 1])

        self.nodelist = list_sort(self.nodelist,
                                  lambda a, b: a.begin <= b.begin)
        if not self.p.no_compatible_edges:
            self._add_compatible_edges()
        # add node weight to outgoing edges
        for node in self.nodelist:
            for e in node.edges:
                e.score = f32(e.score + node.score)
        for node in self.nodelist:
            node.edges = list_sort(node.edges,
                                   lambda a, b: a.to.begin <= b.to.begin)

    def _get_size_neutral_line(self) -> None:
        self.max = 0
        self.min = 2 ** 31 - 1
        for st in self.statelist:
            if st.name in (CDS, UTR3, UTR5):
                if st.end > self.max:
                    self.max = st.end
                if st.begin < self.min:
                    self.min = st.begin

    def _calculate_base_scores(self) -> None:
        processed = set()
        for st in self.statelist:
            k = self.key_status(st)
            if k not in processed:
                processed.add(k)
                for pos in range(st.begin, st.end + 1):
                    bt = self._get_basetype(st, pos)
                    if bt >= 0:
                        self.base_score[bt * self.seqlength + pos] += st.score

    def _get_basetype(self, st: Status, pos: int) -> int:
        t = st.item.type
        if st.name == CDS:
            frame = st.item.frame()
            if _is_on_f_strand(t):
                frame_at_pos = (frame - (st.end + 1) + pos) % 3
            else:
                frame_at_pos = (frame + st.end + 1 - pos) % 3
            if ST.singleG <= t <= ST.terminal:
                return (0, 2, 4)[frame_at_pos]
            return (1, 3, 5)[frame_at_pos]
        if st.name in (UTR3, UTR5):
            if ST.utr5single <= t <= ST.utr3term:
                return 6
            if ST.rutr5single <= t <= ST.rutr3term:
                return 7
            return -1
        if st.name >= INTRON:
            if (ST.singleG <= t < ST.rsingleG) or t == ST.intron_type:
                return 8
            return 9
        return -1

    # -- scoring ------------------------------------------------------------
    def _get_points(self, is_exon: bool, prob: float):
        p = self.p
        if is_exon:
            if prob < p.i1_e:
                return 0.0, p.x0_e, p.i1_e, p.j1_e
            if prob < p.y0_e:
                return p.i1_e, p.j1_e, p.y0_e, 0.0
            if prob < p.i2_e:
                return p.y0_e, 0.0, p.i2_e, p.j2_e
            return p.i2_e, p.j2_e, 1.0, p.x1_e
        else:
            if prob < p.i1_i:
                return 0.0, p.x0_i, p.i1_i, p.j1_i
            if prob < p.y0_i:
                return p.i1_i, p.j1_i, p.y0_i, 0.0
            if prob < p.i2_i:
                return p.y0_i, 0.0, p.i2_i, p.j2_i
            return p.i2_i, p.j2_i, 1.0, p.x1_i

    def _avg_base_prob(self, st: Status) -> float:
        """float32 accumulation as in the reference
        (AugustusGraph::getAvgBaseProb, graph.cc:1282)."""
        if not (st.name >= INTRON or st.name in (CDS, UTR3, UTR5)):
            return 0.0
        prob = f32(0.0)
        for pos in range(st.begin, st.end + 1):
            bt = self._get_basetype(st, pos)
            if bt >= 0:
                prob = f32(prob + f32(self.base_score[bt * self.seqlength
                                                      + pos]))
        return float(f32(prob / f32(st.end - st.begin + 1)))

    def set_score(self, st: Status) -> float:
        """Scores: logistic-regression form when /CompPred/logreg (default),
        else piecewise-linear transform of posteriors + base-level average
        (reference AugustusGraph::setScore, graph.cc:780)."""
        is_exon = st.name in (CDS, UTR3, UTR5)
        if self.p.logreg:
            w = self.p.lg_es if is_exon else self.p.in_sc
            return (w[0] + w[1] * st.score
                    + w[2] * self._avg_base_prob(st)
                    + w[3] * math.log(st.end - st.begin + 1))
        if is_exon:
            a1, a2, b1, b2 = self._get_points(True, st.score)
            s_se = (st.score - a1) * (b2 - a2) / (b1 - a1) + a2
            s_be = 0.0
            a1 = a2 = b1 = b2 = 0.0
            p_b = 0.0
            have = False
            for pos in range(st.begin, st.end + 1):
                bt = self._get_basetype(st, pos)
                if bt >= 0:
                    p_b = self.base_score[bt * self.seqlength + pos]
                    a1, a2, b1, b2 = self._get_points(True, p_b)
                    have = True
                # NOTE: if bt < 0, the previous points/p_b are reused
                # (reference quirk, graph.cc:810-821)
                if have:
                    s_be += (p_b - a1) * (b2 - a2) / (b1 - a1) + a2
            s_be /= st.end - st.begin + 1
            return self.p.alpha_e * s_se + s_be
        else:
            s_bi = 0.0
            a1 = a2 = b1 = b2 = 0.0
            p_b = 0.0
            have = False
            for pos in range(st.begin, st.end + 1):
                bt = self._get_basetype(st, pos)
                if bt >= 0:
                    p_b = self.base_score[bt * self.seqlength + pos]
                    a1, a2, b1, b2 = self._get_points(False, p_b)
                    have = True
                if have:
                    s_bi += (p_b - a1) * (b2 - a2) / (b1 - a1) + a2
            s_bi /= st.end - st.begin + 1
            a1, a2, b1, b2 = self._get_points(False, st.score)
            s_si = (st.score - a1) * (b2 - a2) / (b1 - a1) + a2
            return self.p.alpha_i * s_si + s_bi

    # -- node/edge insertion ------------------------------------------------
    def _add_exon(self, exon: Status, neutral_line) -> Node:
        k = self.key_status(exon)
        if k not in self.hash:
            ex = Node(exon.begin, exon.end, self.set_score(exon), exon.item,
                      "sampled")
            self.nodelist.append(ex)
            self.hash[k] = ex
            if self._exon_at_gene_start(exon):
                nk = "%d:neutral" % ex.begin
                if nk not in self.hash:
                    neut = Node(ex.begin, ex.begin, 0.0, None, "IR")
                    neutral_line[ex.begin - self.min] = neut
                    neut.edges.append(Edge(ex, False))
                    self.nodelist.append(neut)
                    self.hash[nk] = neut
                else:
                    self.hash[nk].edges.append(Edge(ex, False))
            if self._exon_at_gene_end(exon):
                nk = "%d:neutral" % ex.end
                if nk not in self.hash:
                    neut = Node(ex.end, ex.end, 0.0, None, "IR")
                    neutral_line[ex.end - self.min] = neut
                    ex.edges.append(Edge(neut, False))
                    self.nodelist.append(neut)
                    self.hash[nk] = neut
                else:
                    ex.edges.append(Edge(self.hash[nk], False))
            return ex
        return self.hash[k]

    def _edge_exists(self, n1: Node, n2: Node) -> bool:
        if n1 is None or n2 is None:
            return False
        return any(e.to is n2 for e in n1.edges)

    def _add_pair(self, exon1: Status, exon2: Status, neutral_line) -> None:
        e1 = self._add_exon(exon1, neutral_line)
        e2 = self._add_exon(exon2, neutral_line)
        if exon1.next is exon2 and not self._edge_exists(e1, e2):
            e1.edges.append(Edge(e2, False))
        elif exon1.next is not exon2 and not self._edge_exists(e1, e2) \
                and not self._merged_stopcodon(e1, e2):
            e1.edges.append(Edge(e2, False, self.set_score(exon1.next),
                                 exon1.next.item))

    def _create_neutral_line(self, neutral_line) -> None:
        pos = self.head
        for nd in neutral_line:
            if nd is not None:
                pos.edges.append(Edge(nd, True, 0.0))
                pos = nd
        pos.edges.append(Edge(self.tail, True, 0.0))

    def _get_intron_score(self, pred_exon, next_exon) -> float:
        """reference getIntronScore (graph.cc:642)."""
        sl = self.statelist
        if next_exon is not None:
            for i, st in enumerate(sl):
                if st is next_exon and i > 0:
                    if sl[i - 1].next is not None:
                        return self.set_score(sl[i - 1])
                    return 0.0
        elif pred_exon is not None:
            for i, st in enumerate(sl):
                if st is pred_exon and st.next is not None:
                    return self.set_score(sl[i + 1])
        return 0.0

    def _add_edge_from_head(self, exon: Optional[Status]) -> None:
        if exon is None:
            return
        if exon.name in (CDS, UTR3, UTR5):
            node = self.hash.get(self.key_status(exon))
            if not self._edge_exists(self.head, node) \
                    and not self._exon_at_gene_start(exon):
                self.head.edges.append(
                    Edge(node, False, self._get_intron_score(None, exon)))
        elif exon.next is not None:
            self._add_edge_from_head(exon.next)

    def _add_edge_to_tail(self, exon: Status) -> None:
        ex = self.hash[self.key_status(exon)]
        if not self._edge_exists(ex, self.tail):
            if not self._exon_at_gene_end(exon):
                ex.edges.append(
                    Edge(self.tail, False,
                         self._get_intron_score(exon, None)))

    # -- predicates ---------------------------------------------------------
    def _exon_at_gene_start(self, st: Status) -> bool:
        t = st.item.type
        if not self.utr:
            return t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2,
                         ST.rsingleG, ST.rterminal0, ST.rterminal1,
                         ST.rterminal2)
        return t in (ST.utr5single, ST.utr5init, ST.rutr3single,
                     ST.rutr3term)

    def _exon_at_gene_end(self, st: Status) -> bool:
        t = st.item.type
        if not self.utr:
            return t in (ST.singleG, ST.terminal, ST.rsingleG, ST.rinitial)
        return t in (ST.utr3single, ST.utr3term, ST.rutr5single,
                     ST.rutr5init)

    def _exon_at_coding_start(self, n: Node) -> bool:
        t = n.item.type
        return (ST.singleG <= t < ST.internal0) or t == ST.rsingleG or \
            (ST.rterminal0 <= t <= ST.rterminal2)

    def _exon_at_coding_end(self, n: Node) -> bool:
        t = n.item.type
        return t in (ST.singleG, ST.terminal, ST.rsingleG, ST.rinitial)

    def _same_strand(self, a: ST, b: ST) -> bool:
        return ((ST.singleG <= a < ST.rsingleG)
                and (ST.singleG <= b < ST.rsingleG)) or \
               ((ST.rsingleG <= a < ST.intron_type)
                and (ST.rsingleG <= b < ST.intron_type))

    def _same_reading_frame(self, e1: Node, e2: Node) -> bool:
        a, b = e1.item, e2.item
        if _is_on_f_strand(a.type) and _is_on_f_strand(b.type):
            return a.frame() == (b.frame() - (b.end - b.begin + 1) % 3) % 3
        return a.frame() == (b.frame() + (b.end - b.begin + 1) % 3) % 3

    def _compatible(self, e1: Node, e2: Node) -> bool:
        if e1.item is None or e2.item is None:
            return False
        t1, t2 = e1.item.type, e2.item.type
        if is_coding_exon(t1) and is_coding_exon(t2) and e1.end < e2.begin \
                and self._same_strand(t1, t2) \
                and self._same_reading_frame(e1, e2) \
                and not self._exon_at_coding_end(e1) \
                and not self._exon_at_coding_start(e2):
            return True
        if e1.end == e2.begin - 1 and self._same_strand(t1, t2) and (
                (t1 in (ST.utr5single, ST.utr5term)
                 and ST.singleG <= t2 < ST.internal0)
                or (t1 in (ST.rutr3init, ST.rutr3single)
                    and ((ST.rinternal2 < t2 <= ST.rterminal2)
                         or t2 == ST.rsingleG))
                or (t1 in (ST.singleG, ST.terminal)
                    and t2 in (ST.utr3single, ST.utr3init))
                or (t1 in (ST.rsingleG, ST.rinitial)
                    and t2 in (ST.rutr5single, ST.rutr5term))):
            return True
        if ((_is_3utr_exon(t1) and _is_3utr_exon(t2)
             and ((t1 in (ST.utr3init, ST.utr3internal)
                   and t2 in (ST.utr3internal, ST.utr3term))
                  or (t1 in (ST.rutr3term, ST.rutr3internal)
                      and t2 in (ST.rutr3internal, ST.rutr3init))))
            or (_is_5utr_exon(t1) and _is_5utr_exon(t2)
                and ((t1 in (ST.utr5init, ST.utr5internal)
                      and t2 in (ST.utr5internal, ST.utr5term))
                     or (t1 in (ST.rutr5term, ST.rutr5internal)
                         and t2 in (ST.rutr5internal, ST.rutr5init))))) \
                and self._same_strand(t1, t2) and e1.end < e2.begin:
            return True
        return False

    def _merged_stopcodon(self, e1, e2) -> bool:
        if isinstance(e1, Node):
            t1 = e1.item.type if e1.item is not None else None
            t2 = e2.item.type if e2.item is not None else None
            end1, begin2 = e1.end, e2.begin
        else:
            if e1 is None or e2 is None:
                return False
            t1, t2 = e1.item.type, e2.item.type
            end1, begin2 = e1.end, e2.begin
        if t1 is None or t2 is None:
            return False
        if not (is_coding_exon(t1) and is_coding_exon(t2)):
            return False
        codes = self.codes
        joined = None
        if t1 in (ST.initial1, ST.internal1, ST.rterminal1, ST.rinternal1):
            joined = [int(codes[end1]), int(codes[begin2]),
                      int(codes[begin2 + 1])] \
                if begin2 + 1 < codes.shape[0] else None
        elif t1 in (ST.initial2, ST.internal2, ST.rterminal0,
                    ST.rinternal0):
            joined = [int(codes[end1 - 1]), int(codes[end1]),
                      int(codes[begin2])]
        if joined is None:
            return False
        if any(c == genetics.N for c in joined):
            return False
        idx = joined[0] * 16 + joined[1] * 4 + joined[2]
        if _is_on_f_strand(t1):
            return bool(self.gcode.is_stop[idx])
        # reverse-complement stop codon
        comp = genetics.COMPLEMENT
        ridx = int(comp[joined[2]]) * 16 + int(comp[joined[1]]) * 4 \
            + int(comp[joined[0]])
        return bool(self.gcode.is_stop[ridx])

    def _add_compatible_edges(self) -> None:
        self.statelist.sort(key=lambda s: (s.begin, s.end))
        processed_start = set()
        for i1, e1 in enumerate(self.nodelist):
            if e1.item is not None and self.key_node(e1) \
                    not in processed_start:
                processed_start.add(self.key_node(e1))
                count = 0
                processed_end = set()
                for e2 in self.nodelist[i1:]:
                    if e2.item is not None and self.key_node(e2) \
                            not in processed_end:
                        processed_end.add(self.key_node(e2))
                        if self._compatible(e1, e2) \
                                and not self._edge_exists(e1, e2):
                            self._insert_intron(e1, e2)
                            count += 1
                        if count > 10 or e2.begin - e1.end > 5000:
                            break

    def _insert_intron(self, n1: Node, n2: Node) -> None:
        if n1.item is None and n2.item is None:
            n1.edges.append(Edge(n2))
        elif not self._merged_stopcodon(n1, n2):
            n1.edges.append(Edge(n2, False))

    # -- back edges (meaPath calls this) ------------------------------------
    def add_back_edges(self) -> None:
        """reference Graph::addBackEdges (graph.cc:230)."""
        neutral_nodes: List[Node] = []
        pos = self.head
        while pos is not self.tail:
            neutral_nodes.append(pos)
            advanced = False
            for e in pos.edges:
                if e.neutral:
                    pos = e.to
                    advanced = True
                    break
            if not advanced:
                break   # "neutral line has gap"
        neutral_nodes.append(self.tail)

        for fi, from_neut in enumerate(neutral_nodes):
            if not self._nonneutral_incoming_edge(from_neut):
                continue
            non_neutral_loop = False
            ti = fi
            while ti > 0:
                to_neut = neutral_nodes[ti]
                if non_neutral_loop:
                    break
                non_neutral_loop = True
                in_queue = set()
                q: List[Node] = []
                nr_non_neutral = sum(1 for e in to_neut.edges
                                     if not e.neutral)
                if nr_non_neutral > 0 and from_neut is not to_neut:
                    q.append(to_neut)
                    goto_next = False
                    while q and not goto_next:
                        pos = q.pop(0)
                        for e in pos.edges:
                            if self.key_node(e.to) not in in_queue:
                                q.append(e.to)
                                in_queue.add(self.key_node(e.to))
                            if pos.item is not None and e.to.item is None \
                                    and e.to.begin <= from_neut.begin:
                                goto_next = True
                                break
                            if q and min(n.begin for n in q) \
                                    > from_neut.begin:
                                self._insert_intron(from_neut, to_neut)
                                non_neutral_loop = False
                                goto_next = True
                                break
                ti -= 1

    def _nonneutral_incoming_edge(self, exon: Node) -> bool:
        for ex in self.nodelist:
            if ex.begin > exon.begin:
                return False
            for e in ex.edges:
                if not e.neutral and e.to is exon:
                    return True
        return False


def _is_on_f_strand(t: ST) -> bool:
    return ST.singleG <= t < ST.rsingleG or \
        (ST.intron_type == t) or (ST.utr5single <= t <= ST.utr3term)


def _is_3utr_exon(t: ST) -> bool:
    return t in (ST.utr3single, ST.utr3init, ST.utr3internal, ST.utr3term,
                 ST.rutr3single, ST.rutr3init, ST.rutr3internal,
                 ST.rutr3term)


def _is_5utr_exon(t: ST) -> bool:
    return t in (ST.utr5single, ST.utr5init, ST.utr5internal, ST.utr5term,
                 ST.rutr5single, ST.rutr5init, ST.rutr5internal,
                 ST.rutr5term)


# ---------------------------------------------------------------------------
# Longest path (reference MEApath, meaPath.cc)
# ---------------------------------------------------------------------------

class MEAPath:
    def __init__(self, graph: AugustusGraph):
        self.graph = graph
        self.top_sort: List[Node] = []
        self.processed = set()

    def find(self) -> List[Node]:
        self._topological_ordering()
        self.graph.add_back_edges()
        self._relax()
        # backtracking
        path: List[Node] = []
        pos = self.graph.tail
        path.insert(0, pos)
        while pos.pred is not None:
            path.insert(0, pos.pred)
            pos = pos.pred
        return path

    def _dfs(self, root: Node) -> None:
        # iterative replica of the recursive dfs (meaPath.cc:47): postorder
        # with edge order preserved
        g = self.graph
        stack = [(root, 0)]
        self.processed.add(g.key_node(root))
        while stack:
            node, ei = stack[-1]
            if ei < len(node.edges):
                stack[-1] = (node, ei + 1)
                to = node.edges[ei].to
                if g.key_node(to) not in self.processed:
                    self.processed.add(g.key_node(to))
                    stack.append((to, 0))
            else:
                stack.pop()
                self.top_sort.append(node)

    def _topological_ordering(self) -> None:
        for node in self.graph.nodelist:
            if self.graph.key_node(node) not in self.processed:
                self._dfs(node)

    def _relax(self) -> None:
        g = self.graph
        for n in g.nodelist:
            n.score = NEG_INF32
        g.head.score = f32(0.0)
        continue_relax = True
        while continue_relax:
            nothing_changed = True
            for i in range(len(self.top_sort) - 1, -1, -1):
                n = self.top_sort[i]
                for e in n.edges:
                    cand = f32(n.score + e.score)
                    if cand > e.to.score:
                        e.to.score = cand
                        e.to.pred = n
                        nothing_changed = False
            if nothing_changed:
                continue_relax = False


# ---------------------------------------------------------------------------
# Path -> gene list (reference getMeaGenelist, mea.cc:187)
# ---------------------------------------------------------------------------

def get_mea_genelist(mea_path: List[Node], utr: bool) -> List[og.Gene]:
    genes: List[og.Gene] = []
    current = og.Gene(apostprob=0.0)   # fresh Gene: apostprob 0 (gene.hh:130)
    for node in reversed(mea_path):
        if node.item is not None:
            ex = copy.copy(node.item)
            _add_exon_to_gene(current, ex)
            pred = node.pred
            if pred is None:
                continue
            if pred.item is not None:
                if pred.end != node.begin - 1:
                    _add_intron_to_gene(current, pred, node)
            else:
                _set_gene_properties(current, utr)
                genes.insert(0, current)
                current = og.Gene(apostprob=0.0)
    return genes


def _add_exon_to_gene(g: og.Gene, exon) -> None:
    if is_coding_exon(exon.type):
        g.exons.insert(0, exon)
    elif _is_5utr_exon(exon.type):
        g.utr5exons.insert(0, exon)
    elif _is_3utr_exon(exon.type):
        g.utr3exons.insert(0, exon)


def _add_intron_to_gene(g: og.Gene, pred: Node, node: Node) -> None:
    intron_item = None
    for e in pred.edges:
        if e.to is node:
            intron_item = e.item
            break
    if intron_item is not None:
        intr = copy.copy(intron_item)
    else:
        intr = og.PathState(pred.end + 1, node.begin - 1,
                            _intron_state_type(pred.item, node.item))
    t = intr.type
    if og.is_coding_intron(t) or t in (ST.intron_type, ST.rintron_type):
        g.introns.insert(0, intr)
    elif t in (ST.utr5intron, ST.utr5intronvar, ST.rutr5intron,
               ST.rutr5intronvar):
        g.utr5introns.insert(0, intr)
    elif t in (ST.utr3intron, ST.utr3intronvar, ST.rutr3intron,
               ST.rutr3intronvar):
        g.utr3introns.insert(0, intr)


def _intron_state_type(e1, e2) -> ST:
    t1, t2 = e1.type, e2.type
    if ST.utr5single <= t1 <= ST.utr5term and \
            ST.utr5single <= t2 <= ST.utr5term:
        return ST.utr5intron
    if ST.rutr5single <= t1 <= ST.rutr5term and \
            ST.rutr5single <= t2 <= ST.rutr5term:
        return ST.rutr5intron
    if ST.utr3single <= t1 <= ST.utr3term and \
            ST.utr3single <= t2 <= ST.utr3term:
        return ST.utr3intron
    if ST.rutr3single <= t1 <= ST.rutr3term and \
            ST.rutr3single <= t2 <= ST.rutr3term:
        return ST.rutr3intron
    if (ST.singleG <= t1 <= ST.terminal) or (ST.singleG <= t2 <= ST.terminal):
        return ST.intron_type
    if (ST.rsingleG <= t1 <= ST.rterminal2) or \
            (ST.rsingleG <= t2 <= ST.rterminal2):
        return ST.rintron_type
    return ST.igenic


def _set_gene_properties(g: og.Gene, utr: bool) -> None:
    """reference setGeneProperties (mea.cc:311), coding-transcript case."""
    if g.exons:
        g.strand = "+" if _is_on_f_strand(g.exons[0].type) else "-"
    cod_start = cod_end = 0
    if g.exons:
        cod_start = min(e.begin for e in g.exons)
        cod_end = max(e.end for e in g.exons)
    g.codingstart = cod_start
    g.codingend = cod_end
    if not utr:
        g.transstart = cod_start
        g.transend = cod_end
    else:
        if g.strand == "+":
            left, right = g.utr5exons, g.utr3exons
        else:
            left, right = g.utr3exons, g.utr5exons
        trans_start = min([e.begin for e in left] + [cod_start])
        trans_end = max([e.end for e in right] + [cod_end])
        g.transstart = trans_start
        g.transend = trans_end
        if g.strand == "+":
            if g.utr5exons and g.utr5exons[0].type in (ST.utr5internal,
                                                       ST.utr5term):
                g.complete5utr = False
            if g.utr3exons:
                if g.utr3exons[-1].type in (ST.utr3init, ST.utr3internal):
                    g.complete3utr = False
            else:
                g.complete3utr = False
        else:
            if g.utr3exons and g.utr3exons[0].type in (ST.rutr3internal,
                                                       ST.rutr3init):
                g.complete3utr = False
            if g.utr5exons:
                if g.utr5exons[-1].type in (ST.rutr5internal, ST.rutr5term):
                    g.complete5utr = False
            else:
                g.complete5utr = False
    if g.exons:
        clength = sum(e.end - e.begin + 1 for e in g.exons)
        first, last = g.exons[0], g.exons[-1]
        if first.truncated & og.TRUNC_LEFT or \
                not (is_initial_exon(first.type)
                     or is_r_terminal_exon(first.type)
                     or first.type in (ST.singleG, ST.rsingleG)) or \
                last.truncated & og.TRUNC_RIGHT or \
                last.type not in (ST.terminal, ST.rinitial, ST.singleG,
                                  ST.rsingleG):
            g.complete = False


# ---------------------------------------------------------------------------
# entry point (reference getMEAtranscripts, mea.cc:82)
# ---------------------------------------------------------------------------

def get_mea_transcripts(transcripts: List[og.Gene], codes: np.ndarray,
                        props, gcode) -> List[og.Gene]:
    if not transcripts:
        return []
    utr = props.get_bool("UTR", False)
    stlist = build_status_list(transcripts, utr)
    graph = AugustusGraph(stlist, codes, MeaParams(props), utr, gcode)
    graph.build()
    path = MEAPath(graph).find()
    return get_mea_genelist(path, utr)
