"""State path -> biological gene structures -> GFF/GTF text.

Replicates the reference pipeline (src/gene.cc):
  condenseStatePath (gene.cc:977) -> projectOntoGeneSequence (gene.cc:394)
  -> filterGenePrediction (gene.cc:2465) -> groupTranscriptsToGenes
  (gene.cc:3191) -> printGeneList (gene.cc:3071) with Gene::printGFF
  formatting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import genetics
from ..constants import Constants, ASS_MIDDLE, DSS_MIDDLE
from ..model.state_config import (ST, STATE_READING_FRAMES, is_on_f_strand,
                                  is_coding_exon, is_initial_exon,
                                  is_internal_exon, is_nc, is_r_internal_exon,
                                  is_r_terminal_exon)

TRUNC_LEFT = 1
TRUNC_RIGHT = 2


def mod3(x):
    return x % 3 if x >= 0 else (x % 3 + 3) % 3


def fmt3(x: float) -> str:
    """C++ `setprecision(3)` default-format equivalent."""
    s = f"{x:.3g}"
    # C++ prints exponents like 1e-05; python gives 1e-05 as well
    return s


@dataclass
class PathState:
    begin: int
    end: int
    type: ST
    truncated: int = 0
    prob: float = 1.0
    frame_mod: int = 0
    has_score: bool = False
    apostprob: float = 0.0
    sample_count: int = 0

    def length(self) -> int:
        return self.end - self.begin + 1

    def frame(self) -> int:
        return mod3(int(STATE_READING_FRAMES[self.type]) + self.frame_mod)


def is_coding_intron(t: ST) -> bool:
    return (ST.lessD0 <= t <= ST.longass2) or (ST.rlessD0 <= t <= ST.rlongass2)


def is_intron_state(t: ST) -> bool:
    return is_coding_intron(t) or t in (
        ST.utr5intron, ST.utr5intronvar, ST.utr3intron, ST.utr3intronvar,
        ST.rutr5intron, ST.rutr5intronvar, ST.rutr3intron, ST.rutr3intronvar,
        ST.ncintron, ST.ncintronvar, ST.rncintron, ST.rncintronvar,
        ST.intron_type, ST.rintron_type)


def is_exon_state(t: ST) -> bool:
    return (is_coding_exon(t)
            or t in (ST.utr5single, ST.utr5init, ST.utr5internal, ST.utr5term,
                     ST.utr3single, ST.utr3init, ST.utr3internal, ST.utr3term,
                     ST.rutr5single, ST.rutr5init, ST.rutr5internal,
                     ST.rutr5term, ST.rutr3single, ST.rutr3init,
                     ST.rutr3internal, ST.rutr3term,
                     ST.ncsingle, ST.ncinit, ST.ncinternal, ST.ncterm,
                     ST.rncsingle, ST.rncinit, ST.rncinternal, ST.rncterm))


def set_trunc_flag(st: PathState, pred_end: int, dnalen: int) -> None:
    """reference State::setTruncFlag (gene.cc:159)."""
    t = st.type
    if st.end == dnalen - 1 and (
            is_initial_exon(t) or is_internal_exon(t) or
            is_r_terminal_exon(t) or is_r_internal_exon(t) or
            is_intron_state(t) or t in (ST.utr3single, ST.utr3term)):
        st.truncated |= TRUNC_RIGHT
    if pred_end in (-1, 0) and (
            is_internal_exon(t) or t == ST.terminal or
            is_r_internal_exon(t) or t == ST.rinitial or
            is_intron_state(t) or
            (is_exon_state(t) and not is_coding_exon(t)
             and t not in (ST.ncsingle, ST.ncinit, ST.ncinternal, ST.ncterm,
                           ST.rncsingle, ST.rncinit, ST.rncinternal, ST.rncterm))):
        st.truncated |= TRUNC_LEFT


def get_biological_state(st: PathState, cn: Constants) -> PathState:
    """reference State::getBiologicalState (gene.cc:176)."""
    t = st.type
    bs = 0
    es = 0
    frame_mod = 0
    trunc_l = st.truncated & TRUNC_LEFT
    trunc_r = st.truncated & TRUNC_RIGHT
    # begin shift
    if t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2):
        bs = cn.trans_init_window
    elif t in (ST.internal0, ST.internal1, ST.internal2, ST.terminal):
        if not trunc_l:
            bs = -cn.ass_end
    elif t in (ST.rinternal0, ST.rinternal1, ST.rinternal2, ST.rinitial):
        if not trunc_l:
            bs = -cn.dss_start
    elif t == ST.intron_type:
        bs = cn.dss_start if not trunc_l else -1
    elif t == ST.rintron_type:
        bs = cn.ass_end if not trunc_l else -1
    elif t in (ST.utr5single, ST.utr5init):
        bs = cn.tss_upwindow_size
    elif t == ST.rutr5single:
        bs = -cn.trans_init_window if not trunc_l else -st.begin
    elif t in (ST.rutr5init, ST.rutr5internal, ST.rutr3init, ST.rutr3internal,
               ST.rncinternal, ST.rncinit):
        bs = cn.dss_end + DSS_MIDDLE
    elif t in (ST.utr5internal, ST.utr3internal, ST.utr3term, ST.utr5term,
               ST.ncinternal, ST.ncterm):
        bs = cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
    elif t == ST.rutr5term:
        bs = -cn.trans_init_window
    elif t == ST.utr3single:
        if trunc_l and st.begin == 1:
            bs = -1
    elif t in (ST.rutr3single, ST.rutr3term):
        if st.begin < 0:
            bs = -st.begin
    # end shift
    if t in (ST.rsingleG, ST.rinitial):
        es = -cn.trans_init_window
    elif t in (ST.initial0, ST.initial1, ST.initial2):
        if not trunc_r:
            es = cn.dss_start
        else:
            frame_mod = mod3(-cn.dss_start)
    elif t in (ST.rterminal0, ST.rterminal1, ST.rterminal2,
               ST.rinternal0, ST.rinternal1, ST.rinternal2):
        if not trunc_r:
            es = cn.ass_end
        else:
            frame_mod = mod3(cn.ass_end)
    elif t in (ST.internal0, ST.internal1, ST.internal2):
        if not trunc_r:
            es = cn.dss_start
        else:
            frame_mod = mod3(-cn.dss_start)
    elif t == ST.intron_type:
        if not trunc_r:
            es = -cn.ass_end
    elif t == ST.rintron_type:
        if not trunc_r:
            es = -cn.dss_start
    elif t in (ST.utr5single, ST.utr5term):
        es = cn.trans_init_window
    elif t in (ST.rutr5single, ST.rutr5init):
        es = -cn.tss_upwindow_size
    elif t in (ST.utr5init, ST.utr5internal, ST.utr3init, ST.utr3internal,
               ST.ncinit, ST.ncinternal):
        es = -cn.dss_end - DSS_MIDDLE
    elif t in (ST.rutr5internal, ST.rutr5term, ST.rutr3internal, ST.rutr3term,
               ST.rncterm, ST.rncinternal):
        es = -(cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE)
    return PathState(begin=st.begin + bs, end=st.end + es, type=t,
                     truncated=st.truncated, frame_mod=frame_mod,
                     has_score=st.has_score, apostprob=st.apostprob)


@dataclass
class Gene:
    """A transcript: coding (reference class Gene) when ``coding`` is True,
    else a noncoding transcript (reference class Transcript, exons+introns
    only)."""
    coding: bool = True
    exons: List[PathState] = field(default_factory=list)
    introns: List[PathState] = field(default_factory=list)
    utr5exons: List[PathState] = field(default_factory=list)
    utr3exons: List[PathState] = field(default_factory=list)
    utr5introns: List[PathState] = field(default_factory=list)
    utr3introns: List[PathState] = field(default_factory=list)
    strand: str = "+"
    complete: bool = True
    # reference Gene constructor defaults both to true (gene.hh:359)
    complete5utr: bool = True
    complete3utr: bool = True
    frame: int = 0
    clength: int = 0
    transstart: int = -1
    transend: int = -1
    codingstart: int = -1
    codingend: int = -1
    id: str = "t1"
    geneid: str = "g1"
    seqname: str = ""
    apostprob: float = 1.0
    has_probs: bool = False
    viterbi: bool = True
    throwaway: bool = False

    def gene_begin(self) -> int:
        return self.transstart if self.transstart >= 0 else self.codingstart

    def gene_end(self) -> int:
        return self.transend if self.transend >= 0 else self.codingend

    def complete_cds(self) -> bool:
        return self.complete

    def signature(self):
        return (self.strand, tuple((e.begin, e.end, int(e.type))
                                   for e in self.exons),
                tuple((e.begin, e.end) for e in self.utr5exons),
                tuple((e.begin, e.end) for e in self.utr3exons))

    # -- posterior-probability machinery (reference gene.cc:1068-1240) -----
    def ex_in_heads(self) -> List[List[PathState]]:
        """reference Gene::getExInHeads (gene.hh:379)."""
        return [self.exons, self.introns, self.utr5exons, self.utr3exons]

    def _all_states(self):
        for sl in self.ex_in_heads():
            for st in sl:
                yield st

    def set_state_postprobs(self, p: float) -> None:
        for st in self._all_states():
            st.apostprob = p
            st.has_score = True

    def add_state_postprobs(self, p: float) -> None:
        for st in self._all_states():
            st.apostprob += p
            st.has_score = True

    def set_sample_count(self, k: int) -> None:
        for st in self._all_states():
            st.sample_count = k

    def add_sample_count(self, k: int) -> None:
        for st in self._all_states():
            st.sample_count += k

    def set_state_has_score(self, has: bool) -> None:
        for st in self._all_states():
            st.has_score = has

    def norm_post_prob(self, n: float) -> None:
        """reference Transcript::normPostProb (gene.cc:1180); the reference
        stores apostprob as C `float`, so divide in float32."""
        self.apostprob = float(np.float32(self.apostprob) / np.float32(n))
        for st in self._all_states():
            st.apostprob = float(np.float32(st.apostprob) / np.float32(n))

    def states_equal(self, other: "Gene") -> bool:
        """reference Transcript::operator== (gene.cc:1150): pairwise
        begin/end equality over the four state lists (types NOT compared)."""
        for sl1, sl2 in zip(self.ex_in_heads(), other.ex_in_heads()):
            if len(sl1) != len(sl2):
                return False
            for a, b in zip(sl1, sl2):
                if a.begin != b.begin or a.end != b.end:
                    return False
        return True

    def update_post_prob(self, other: "Gene") -> None:
        """reference Transcript::updatePostProb (gene.cc:1202): merge-compare
        each sorted state list; on a begin/end/type match, cross-add the
        other's sampleCount to this state's apostprob (and vice versa)."""
        if other.gene_begin() > self.gene_end() or \
                self.gene_begin() > other.gene_end():
            return
        for sl1, sl2 in zip(self.ex_in_heads(), other.ex_in_heads()):
            i1 = i2 = 0
            while i1 < len(sl1) and i2 < len(sl2):
                st, ot = sl1[i1], sl2[i2]
                if st.begin == ot.begin and st.end == ot.end and \
                        st.type == ot.type:
                    st.apostprob += ot.sample_count
                    ot.apostprob += st.sample_count
                    i1 += 1
                    i2 += 1
                elif st.begin < ot.begin:
                    i1 += 1
                else:
                    i2 += 1

    def mean_state_prob(self) -> float:
        """reference Transcript::meanStateProb (gene.cc:1241): geometric
        mean of all state posteriors."""
        if not self.has_probs:
            return 0.0
        prod = 1.0
        num = 0
        for st in self._all_states():
            prod *= st.apostprob
            num += 1
        return prod ** (1.0 / num) if num else 1.0

    def percent_supported(self) -> float:
        """reference Gene::getPercentSupported; filled in by the evidence
        compiler when hints are present, else 0."""
        return getattr(self, "percent_supp", 0.0)

    def shift_coordinates(self, d: int) -> None:
        """reference Gene::shiftCoordinates (gene.cc:1515), which iterates
        getExInInHeads (incl. UTR introns)."""
        for sl in self.ex_in_heads() + [self.utr5introns, self.utr3introns]:
            for st in sl:
                st.begin += d
                st.end += d
        if self.transstart >= 0:
            self.transstart += d
        if self.transend >= 0:
            self.transend += d
        self.codingstart += d
        self.codingend += d


def condense_path(segments: List[Tuple[int, int, ST]], dnalen: int
                  ) -> List[PathState]:
    """Merge same-type runs; set truncation flags from the raw path.

    `segments` come from the engine traceback left-to-right; pred_end of a
    segment is begin-1.
    """
    raw: List[PathState] = []
    for (b, e, t) in segments:
        st = PathState(begin=b, end=e, type=t)
        set_trunc_flag(st, b - 1, dnalen)
        raw.append(st)
    out: List[PathState] = []
    for st in raw:
        if out and out[-1].type == st.type and not is_coding_exon(st.type):
            out[-1].end = st.end
            out[-1].truncated |= st.truncated
        else:
            out.append(PathState(begin=st.begin, end=st.end, type=st.type,
                                 truncated=st.truncated))
    return out


def project_onto_genes(path: List[PathState], cn: Constants) -> List[Gene]:
    """reference StatePath::projectOntoGeneSequence (gene.cc:394)."""
    from ..model.state_config import is_5utr, is_3utr
    genes: List[Gene] = []
    i = 0
    n = len(path)
    pending: Optional[Gene] = None

    # leading coding intron => incomplete gene starting with intron
    if n and is_coding_intron(path[0].type):
        intron = PathState(begin=path[0].begin, end=0,
                           type=ST.intron_type if is_on_f_strand(path[0].type)
                           else ST.rintron_type)
        intron.truncated |= path[0].truncated
        while i + 1 < n and is_coding_intron(path[i + 1].type):
            i += 1
        intron.end = path[i].end
        intron.truncated |= path[i].truncated
        pending = Gene()
        bio = get_biological_state(intron, cn)
        pending.introns.append(bio)
        pending.transstart = bio.begin
        i += 1

    while i < n:
        while i < n and not is_exon_state(path[i].type):
            i += 1
        if i >= n:
            break
        cur = path[i]
        if is_nc(cur.type):
            i = _project_nc(path, i, cn, genes)
            continue
        g = pending or Gene()
        pending = None
        g.strand = "+" if is_on_f_strand(cur.type) else "-"
        if g.strand == "-":
            g.frame = 2
        last5 = last3 = None
        # ---- left-side UTR --------------------------------------------
        if is_5utr(cur.type):
            first = True
            while i < n and is_5utr(path[i].type):
                st = path[i]
                if first:
                    g.complete5utr = st.type in (ST.utr5single, ST.utr5init)
                    first = False
                if is_exon_state(st.type):
                    g.utr5exons.append(get_biological_state(st, cn))
                i += 1
        elif is_3utr(cur.type):
            first = True
            while i < n and is_3utr(path[i].type):
                st = path[i]
                if first:
                    g.complete3utr = st.type in (ST.rutr3single, ST.rutr3term)
                    first = False
                if is_exon_state(st.type):
                    g.utr3exons.append(get_biological_state(st, cn))
                i += 1
        if i < n and is_coding_exon(path[i].type):
            cur = path[i]
            if cur.type in (ST.singleG, ST.rsingleG):
                g.exons.append(get_biological_state(cur, cn))
                i += 1
            else:
                if not (is_initial_exon(cur.type) or is_r_terminal_exon(cur.type)):
                    g.complete = False
                first = get_biological_state(cur, cn)
                g.exons.append(first)
                if g.strand == "+":
                    g.frame = mod3(first.frame() - first.length())
                else:
                    g.frame = mod3(first.frame() + first.length())
                if cur.type in (ST.terminal, ST.rinitial):
                    i += 1
                else:
                    i += 1
                    while i < n and path[i].type not in (ST.terminal,
                                                         ST.rinitial):
                        st = path[i]
                        if is_intron_state(st.type):
                            intron = PathState(
                                begin=st.begin, end=st.end,
                                type=ST.intron_type if is_on_f_strand(st.type)
                                else ST.rintron_type,
                                truncated=st.truncated)
                            while i + 1 < n and is_intron_state(path[i + 1].type):
                                i += 1
                                intron.end = path[i].end
                                intron.truncated = path[i].truncated
                            g.introns.append(get_biological_state(intron, cn))
                            if g.introns[-1].end > g.transstart:
                                g.transend = g.introns[-1].end
                        elif is_internal_exon(st.type) or \
                                is_r_internal_exon(st.type):
                            g.exons.append(get_biological_state(st, cn))
                        else:
                            raise ValueError(
                                "state path doesn't constitute a valid gene")
                        i += 1
                    if i >= n:
                        g.complete = False
                    else:
                        g.exons.append(get_biological_state(path[i], cn))
                        i += 1
            # ---- right-side UTR ---------------------------------------
            if i < n and is_5utr(path[i].type):
                while i < n and is_5utr(path[i].type):
                    st = path[i]
                    if not (i + 1 < n and is_5utr(path[i + 1].type)):
                        g.complete5utr = st.type in (ST.rutr5single,
                                                     ST.rutr5init)
                    if is_exon_state(st.type):
                        g.utr5exons.append(get_biological_state(st, cn))
                        last5 = g.utr5exons[-1]
                    i += 1
            elif i < n and is_3utr(path[i].type):
                while i < n and is_3utr(path[i].type):
                    st = path[i]
                    if not (i + 1 < n and is_3utr(path[i + 1].type)):
                        g.complete3utr = st.type in (ST.utr3single,
                                                     ST.utr3term)
                    if is_exon_state(st.type):
                        g.utr3exons.append(get_biological_state(st, cn))
                        last3 = g.utr3exons[-1]
                    i += 1
        else:
            # gene consists just of UTR: dropped by default
            # (reference Constant::reportUtrOnlyGenes == false)
            continue
        # finish gene
        # UTR introns = gaps between consecutive UTR exons, type intron_type
        # (reference gene.cc:610-637)
        g.utr5introns = [PathState(a.end + 1, b.begin - 1, ST.intron_type)
                         for a, b in zip(g.utr5exons, g.utr5exons[1:])]
        g.utr3introns = [PathState(a.end + 1, b.begin - 1, ST.intron_type)
                         for a, b in zip(g.utr3exons, g.utr3exons[1:])]
        g.clength = sum(e.length() for e in g.exons)
        if g.strand == "-":
            g.frame = mod3(g.frame - g.clength + 1)
        if g.utr5exons and (g.transstart < 0 or
                            g.transstart > g.utr5exons[0].begin):
            g.transstart = g.utr5exons[0].begin
        if g.utr3exons and (g.transstart < 0 or
                            g.transstart > g.utr3exons[0].begin):
            g.transstart = g.utr3exons[0].begin
        if last5 is not None and (g.transend < 0 or g.transend < last5.end):
            g.transend = last5.end
        if last3 is not None and (g.transend < 0 or g.transend < last3.end):
            g.transend = last3.end
        if g.exons:
            g.codingstart = g.exons[0].begin
            g.codingend = g.exons[-1].end
        if g.codingend > g.transend:
            g.transend = -1
        if g.codingstart >= 0 and g.codingstart < g.transstart:
            g.transstart = -1
        genes.append(g)
    return genes


# the nc exon types that open and close a noncoding transcript, by strand
# (left to right along the sequence)
_NC_OPEN = {"+": (ST.ncsingle, ST.ncinit), "-": (ST.rncsingle, ST.rncterm)}
_NC_CLOSE = {"+": (ST.ncsingle, ST.ncterm), "-": (ST.rncsingle, ST.rncinit)}


def _project_nc(path: List[PathState], i: int, cn: Constants,
                genes: List[Gene]) -> int:
    """The noncoding transcript of the run of nc states at path[i] (an nc
    exon), appended to genes; returns the index after the run.  Its exons
    are the biological nc exons, its introns the gaps between them; a
    transcript entered at an open type has its 5' end (+) or 3' end (-)
    complete, one left at a close type the other end (reference
    StatePath::projectOntoGeneSequence, noncoding branch, gene.cc:394)."""
    n = len(path)
    g = Gene(coding=False)
    g.strand = "+" if is_on_f_strand(path[i].type) else "-"
    left = path[i].type in _NC_OPEN[g.strand]
    last = path[i]
    while i < n and is_nc(path[i].type):
        st = path[i]
        if is_exon_state(st.type):
            g.exons.append(get_biological_state(st, cn))
            last = st
        i += 1
    right = last.type in _NC_CLOSE[g.strand]
    if g.strand == "+":
        g.complete5utr, g.complete3utr = left, right
    else:
        g.complete3utr, g.complete5utr = left, right
    g.introns = [PathState(a.end + 1, b.begin - 1, ST.intron_type
                           if g.strand == "+" else ST.rintron_type)
                 for a, b in zip(g.exons, g.exons[1:])]
    g.transstart, g.transend = g.exons[0].begin, g.exons[-1].end
    genes.append(g)
    return i


def coding_sequence(g: Gene, codes: np.ndarray, offset: int = 0) -> np.ndarray:
    """Spliced CDS codes in reading direction (reference getExonicSequence,
    gene.cc:1400: positions are global, sequence is indexed at
    begin - offset)."""
    parts = [codes[e.begin - offset: e.end + 1 - offset] for e in g.exons]
    seq = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)
    if g.strand == "-":
        seq = genetics.reverse_complement(seq)
    return seq


def get_translation(codes: np.ndarray, gcode: genetics.GeneticCode) -> str:
    """reference getTranslation (gene.cc:2338): stops internal -> 'X', final
    stop dropped; non-acgt codons -> 'X'."""
    out = []
    i = 0
    n = codes.shape[0]
    while i + 2 < n:
        cod = codes[i: i + 3]
        if (cod == genetics.N).any():
            out.append("X")
        else:
            aa = gcode.aa_of_codon[int(cod[0]) * 16 + int(cod[1]) * 4 + int(cod[2])]
            if aa != "*":
                out.append(aa)
            elif i + 3 < n:
                out.append("X")
        i += 3
    return "".join(out)


def has_in_frame_stop(g: Gene, codes: np.ndarray,
                      gcode: genetics.GeneticCode) -> bool:
    """reference Gene::hasInFrameStop — internal stop codons only."""
    seq = coding_sequence(g, codes)
    seq = seq[mod3(-g.frame):]
    i = 0
    while seq.shape[0] - i > 3:
        cod = seq[i: i + 3]
        if not (cod == genetics.N).any():
            if gcode.is_stop[int(cod[0]) * 16 + int(cod[1]) * 4 + int(cod[2])]:
                return True
        i += 3
    return False


def filter_transcripts(genes: List[Gene], codes: np.ndarray, cn: Constants,
                       gcode: genetics.GeneticCode, strand: str = "both",
                       no_in_frame_stop: bool = False,
                       keep_viterbi: bool = False,
                       minexonintronprob: float = 0.0,
                       minmeanexonintronprob: float = 0.0) -> List[Gene]:
    """reference filterGenePrediction (gene.cc:2465)."""
    out = []
    for g in genes:
        if strand != "both" and g.strand != strand:
            continue
        if g.throwaway:
            continue
        if g.coding:
            # coding-only filters (reference gene.cc:2480-2489 guards with
            # dynamic_cast<Gene*>)
            ifs = has_in_frame_stop(g, codes, gcode)
            if (g.clength < cn.min_coding_len and g.complete_cds()) or \
                    (ifs and no_in_frame_stop) or \
                    (g.clength < 4 and g.clength < cn.min_coding_len
                     and not g.complete_cds()):
                continue
        if g.has_probs:
            protected = keep_viterbi and g.viterbi
            if g.mean_state_prob() < minmeanexonintronprob and not protected:
                continue
            low = any(st.apostprob < minexonintronprob
                      for st in list(g.exons) + list(g.introns))
            if low and not protected:
                continue
        out.append(g)
    return out


def max_tracks_order(genes: List[Gene], keep_viterbi: bool = False
                     ) -> List[Gene]:
    """reference Transcript::filterTranscriptsByMaxTracks (gene.cc:2533)
    with unlimited tracks: only the selection-sort reordering survives —
    repeatedly pick the transcript with the largest meanStateProb; with
    keep_viterbi, the last remaining viterbi transcript wins each round."""
    rest = list(genes)
    out: List[Gene] = []
    while rest:
        best_i = 0
        best_p = -1.0
        for i, g in enumerate(rest):
            p = g.mean_state_prob()
            if p > best_p:
                best_p = p
                best_i = i
            if g.viterbi and keep_viterbi:
                best_i = i
                best_p = 1.0
        out.append(rest.pop(best_i))
    return out


def sort_transcripts(ag: "AltGene") -> None:
    """reference AltGene::sortTranscripts (gene.cc:2749): selection sort by
    (percentSupported desc, meanStateProb desc)."""
    if len(ag.transcripts) < 2:
        return
    if any(not tx.coding for tx in ag.transcripts):
        # reference breaks out of the scan on the first noncoding
        # transcript ("do not sort noncoding genes (yet)", gene.cc:2766),
        # which preserves insertion order for nc genes
        return
    rest = list(ag.transcripts)
    out: List[Gene] = []
    while rest:
        best_i = 0
        max_supp = 0.0
        max_msp = -1.0
        for i, g in enumerate(rest):
            supp = g.percent_supported()
            msp = g.mean_state_prob()
            if supp > max_supp or (supp == max_supp and msp > max_msp):
                max_supp = supp
                max_msp = msp
                best_i = i
        out.append(rest.pop(best_i))
    ag.transcripts = out


@dataclass
class AltGene:
    transcripts: List[Gene] = field(default_factory=list)
    strand: str = "+"
    mincodstart: int = -1
    maxcodend: int = -1
    id: str = "g1"
    seqname: str = ""
    apostprob: float = 0.0
    has_probs: bool = False

    def add(self, g: Gene) -> None:
        # reference AltGene::addGene (gene.cc:2669): coding transcripts
        # contribute coding bounds, noncoding ones their transcript bounds
        start = g.codingstart if g.coding else g.transstart
        end = g.codingend if g.coding else g.transend
        if not self.transcripts:
            self.strand = g.strand
            self.mincodstart = start
            self.maxcodend = end
        else:
            self.mincodstart = min(self.mincodstart, start)
            self.maxcodend = max(self.maxcodend, end)
        self.transcripts.append(g)
        # the final gene score: joinGenesFromPredRuns regroups transcripts
        # via AltGene::addGene which sums member apostprobs (gene.cc:1669);
        # findGenes' transient overlap-sum is overwritten by that rebuild
        self.apostprob += g.apostprob

    def overlaps(self, g: Gene) -> bool:
        if not g.exons or g.strand != self.strand:
            return False
        if not (g.gene_begin() <= self.maxcodend and
                g.gene_end() >= self.mincodstart):
            return False
        # coding and noncoding genes never overlap (gene.cc:2717)
        if self.transcripts and self.transcripts[0].coding != g.coding:
            return False
        for tx in self.transcripts:
            for ae in tx.exons:
                for e in g.exons:
                    if not (e.end < ae.begin or e.begin > ae.end):
                        # frame_compatible check applies to coding genes
                        # only (gene.cc:2725)
                        if not g.coding or _frame_compatible(e, ae):
                            return True
        return False

    def min_trans_begin(self) -> int:
        return min(tx.gene_begin() for tx in self.transcripts)

    def max_trans_end(self) -> int:
        return max(tx.gene_end() for tx in self.transcripts)

    def shift_coordinates(self, d: int) -> None:
        for tx in self.transcripts:
            tx.shift_coordinates(d)
        self.mincodstart += d
        self.maxcodend += d


def _frame_compatible(e1: PathState, e2: PathState) -> bool:
    """reference frame_compatible(State*, State*): exons on the same strand
    overlapping with matching codon phase."""
    f1 = is_on_f_strand(e1.type)
    f2 = is_on_f_strand(e2.type)
    if f1 != f2:
        return False
    if f1:
        return mod3(e2.end - e1.end - e2.frame() + e1.frame()) == 0
    return mod3(e2.end - e1.end + e2.frame() - e1.frame()) == 0


def group_transcripts(genes: List[Gene]) -> List[AltGene]:
    """reference groupTranscriptsToGenes (gene.cc:3191)."""
    # reference transcripts.sort() is stable with Transcript::operator<
    # comparing geneBegin only (gene.cc:1545)
    genes = sorted(genes, key=lambda g: g.gene_begin())
    agl: List[AltGene] = []
    for g in genes:
        first_olp: Optional[AltGene] = None
        keep: List[AltGene] = []
        for ag in agl:
            if ag.overlaps(g):
                if first_olp is None:
                    ag.add(g)
                    first_olp = ag
                    keep.append(ag)
                else:
                    for tx in ag.transcripts:
                        first_olp.add(tx)
            else:
                keep.append(ag)
        agl = keep
        if first_olp is None:
            ag = AltGene()
            ag.add(g)
            ag.has_probs = True
            agl.append(ag)
    return agl


# ---------------------------------------------------------------------------
# GFF printing
# ---------------------------------------------------------------------------

@dataclass
class OutputOptions:
    print_start: bool = True
    print_stop: bool = True
    print_cds: bool = True
    print_exonnames: bool = False
    print_introns: bool = False
    print_utr: bool = False
    print_tss: bool = True
    print_tts: bool = True
    gff3: bool = False
    protein: bool = True
    codingseq: bool = False
    stop_codon_excluded_from_cds: bool = False
    utr_on: bool = False

    @classmethod
    def from_properties(cls, props) -> "OutputOptions":
        o = cls()
        o.print_start = props.get_bool("start", True)
        o.print_stop = props.get_bool("stop", True)
        o.print_cds = props.get_bool("cds", True)
        o.print_exonnames = props.get_bool("exonnames", False)
        o.print_introns = props.get_bool("introns", False)
        o.print_utr = props.get_bool("print_utr", False)
        o.print_tss = props.get_bool("tss", True)
        o.print_tts = props.get_bool("tts", True)
        o.gff3 = props.get_bool("gff3", False)
        o.protein = props.get_bool("protein", True)
        o.codingseq = props.get_bool("codingseq", False)
        o.stop_codon_excluded_from_cds = props.get_bool(
            "stopCodonExcludedFromCDS", False)
        o.utr_on = props.get_bool("UTR", False)
        return o


def print_gene_gff(g: Gene, o: OutputOptions, out: List[str],
                   source: str = "AUGUSTUS") -> None:
    """reference Gene::printGFF (gene.cc), incl. UTR line formats."""
    tid = f"{g.geneid}.{g.id}"
    parent = (f"Parent={tid}" if o.gff3 else
              f'transcript_id "{tid}"; gene_id "{g.geneid}";')
    sn, src = g.seqname, source
    strand = g.strand
    if not g.coding:
        _print_nc_gff(g, o, out, parent, source)
        return
    exons = g.exons
    first_right_utr = g.utr3exons if strand == "+" else g.utr5exons
    first_left_utr = g.utr5exons if strand == "+" else g.utr3exons

    # ---- left UTR -------------------------------------------------------
    for idx, e in enumerate(first_left_utr):
        if strand == "+" and idx == 0 and e in g.utr5exons[:1] and \
                g.complete5utr and o.print_tss:
            out.append(f"{sn}\t{src}\ttss\t{e.begin + 1}\t{e.begin + 1}"
                       f"\t.\t+\t.\t{parent}")
        if strand == "-" and idx == 0 and e in g.utr3exons[:1] and \
                g.complete3utr and o.print_tts:
            out.append(f"{sn}\t{src}\ttts\t{e.begin + 1}\t{e.begin + 1}"
                       f"\t.\t-\t.\t{parent}")
        if o.print_utr:
            if e.end >= e.begin:
                name = "5'-UTR" if strand == "+" else "3'-UTR"
                if o.gff3:
                    name = ("five_prime_utr" if strand == "+"
                            else "three_prime_utr")
                score = fmt3(e.apostprob) if e.has_score else "."
                out.append(f"{sn}\t{src}\t{name}\t{e.begin + 1}\t"
                           f"{e.end + 1}\t{score}\t{strand}\t.\t{parent}")
        else:
            frm, to = e.begin + 1, e.end + 1
            if idx == len(first_left_utr) - 1:   # last left utr exon
                if exons:
                    to = exons[0].end + 1
                    if len(exons) == 1 and first_right_utr:
                        to = first_right_utr[0].end + 1
            out.append(f"{sn}\t{src}\texon\t{frm}\t{to}\t.\t{strand}"
                       f"\t.\t{parent}")

    if exons:
        first = exons[0]
        if o.print_start and strand == "+" and \
                (is_initial_exon(first.type) or first.type == ST.singleG):
            out.append(f"{sn}\t{src}\tstart_codon\t{first.begin + 1}\t"
                       f"{first.begin + 3}\t.\t+\t0\t{parent}")
        if o.print_stop and strand == "-" and (
                first.type in (ST.terminal, ST.singleG, ST.rsingleG)
                or is_r_terminal_exon(first.type)):
            out.append(f"{sn}\t{src}\tstop_codon\t{first.begin + 1}\t"
                       f"{first.begin + 3}\t.\t-\t0\t{parent}")
    for e in exons:
        if o.print_exonnames and not o.gff3:
            if e.type in (ST.singleG, ST.rsingleG):
                name = "single"
            elif is_initial_exon(e.type) or e.type == ST.rinitial:
                name = "initial"
            elif e.type == ST.terminal or is_r_terminal_exon(e.type):
                name = "terminal"
            else:
                name = "internal"
            score = fmt3(e.apostprob) if e.has_score else "."
            frame = (mod3(3 - (e.frame() - e.length())) if strand == "+"
                     else mod3(2 - e.frame()))
            out.append(f"{sn}\t{src}\t{name}\t{e.begin + 1}\t{e.end + 1}\t"
                       f"{score}\t{strand}\t{frame}\t"
                       f'transcript_id "{tid}"; gene_id "{g.geneid}";')
    if o.print_introns:
        for it in g.introns:
            score = fmt3(it.apostprob) if it.has_score else "."
            out.append(f"{sn}\t{src}\tintron\t{it.begin + 1}\t{it.end + 1}"
                       f"\t{score}\t{strand}\t.\t{parent}")
    for ei, e in enumerate(exons):
        if o.print_cds:
            beginmod = endmod = 0
            if o.stop_codon_excluded_from_cds:
                if e.type in (ST.terminal, ST.singleG):
                    endmod = -3
                if is_r_terminal_exon(e.type) or e.type == ST.rsingleG:
                    beginmod = 3
            if e.begin + 1 + beginmod <= e.end + 1 + endmod:
                score = fmt3(e.apostprob) if e.has_score else "."
                frame = (mod3(3 - (e.frame() - e.length())) if strand == "+"
                         else mod3(2 - e.frame()))
                cdsattr = f"ID={tid}.cds;" if o.gff3 else ""
                out.append(f"{sn}\t{src}\tCDS\t{e.begin + 1 + beginmod}\t"
                           f"{e.end + 1 + endmod}\t{score}\t{strand}\t"
                           f"{frame}\t{cdsattr}{parent}")
        if o.utr_on and not o.print_utr:
            if ei != 0 or not first_left_utr:
                frm, to = e.begin + 1, e.end + 1
                if ei == len(exons) - 1 and first_right_utr:
                    to = first_right_utr[0].end + 1
                out.append(f"{sn}\t{src}\texon\t{frm}\t{to}\t.\t"
                           f"{strand}\t.\t{parent}")
    if exons:
        last = exons[-1]
        if o.print_stop and strand == "+" and last.type in (ST.terminal,
                                                            ST.singleG):
            out.append(f"{sn}\t{src}\tstop_codon\t{last.end - 1}\t"
                       f"{last.end + 1}\t.\t+\t0\t{parent}")
        if o.print_start and strand == "-" and (
                is_initial_exon(last.type) or last.type in (
                    ST.singleG, ST.rinitial, ST.rsingleG)):
            out.append(f"{sn}\t{src}\tstart_codon\t{last.end - 1}\t"
                       f"{last.end + 1}\t.\t-\t0\t{parent}")

    # ---- right UTR ------------------------------------------------------
    for idx, e in enumerate(first_right_utr):
        if o.print_utr:
            if e.end >= e.begin:
                name = "3'-UTR" if strand == "+" else "5'-UTR"
                if o.gff3:
                    name = ("three_prime_utr" if strand == "+"
                            else "five_prime_utr")
                score = fmt3(e.apostprob) if e.has_score else "."
                out.append(f"{sn}\t{src}\t{name}\t{e.begin + 1}\t"
                           f"{e.end + 1}\t{score}\t{strand}\t.\t{parent}")
        else:
            if idx != 0:
                out.append(f"{sn}\t{src}\texon\t{e.begin + 1}\t"
                           f"{e.end + 1}\t.\t{strand}\t.\t{parent}")
        if idx == len(first_right_utr) - 1:
            if strand == "+" and g.complete3utr and o.print_tts:
                out.append(f"{sn}\t{src}\ttts\t{e.end + 1}\t{e.end + 1}"
                           f"\t.\t+\t.\t{parent}")
            if strand == "-" and g.complete5utr and o.print_tss:
                out.append(f"{sn}\t{src}\ttss\t{e.end + 1}\t{e.end + 1}"
                           f"\t.\t-\t.\t{parent}")


def _print_nc_gff(g: Gene, o: OutputOptions, out: List[str], parent: str,
                  src: str) -> None:
    """reference Transcript::printGFF (gene.cc:1285) for a noncoding
    transcript: the tss and tts lines where its ends are complete, its exons
    and, with --introns=on, its introns."""
    sn, strand = g.seqname, g.strand
    lo, hi = g.transstart + 1, g.transend + 1
    if strand == "+" and g.complete5utr and o.print_tss:
        out.append(f"{sn}\t{src}\ttss\t{lo}\t{lo}\t.\t+\t.\t{parent}")
    if strand == "-" and g.complete3utr and o.print_tts:
        out.append(f"{sn}\t{src}\ttts\t{lo}\t{lo}\t.\t-\t.\t{parent}")
    for e in g.exons:
        score = fmt3(e.apostprob) if e.has_score else "."
        out.append(f"{sn}\t{src}\texon\t{e.begin + 1}\t{e.end + 1}\t{score}"
                   f"\t{strand}\t.\t{parent}")
    if o.print_introns:
        for it in g.introns:
            score = fmt3(it.apostprob) if it.has_score else "."
            out.append(f"{sn}\t{src}\tintron\t{it.begin + 1}\t{it.end + 1}"
                       f"\t{score}\t{strand}\t.\t{parent}")
    if strand == "+" and g.complete3utr and o.print_tts:
        out.append(f"{sn}\t{src}\ttts\t{hi}\t{hi}\t.\t+\t.\t{parent}")
    if strand == "-" and g.complete5utr and o.print_tss:
        out.append(f"{sn}\t{src}\ttss\t{hi}\t{hi}\t.\t-\t.\t{parent}")


def print_sequences(g: Gene, codes: np.ndarray, o: OutputOptions,
                    gcode: genetics.GeneticCode, out: List[str],
                    seq_offset: int = 0) -> None:
    cds = coding_sequence(g, codes, seq_offset)
    if o.codingseq:
        text = genetics.decode(cds)
        line = "# coding sequence = ["
        linelength = 100
        cur = len(line)
        off = 0
        while off < len(text):
            line += text[off: off + linelength - cur]
            off += linelength - cur
            if off < len(text):
                out.append(line)
                line = "# "
                cur = 2
        out.append(line + "]")
    if o.protein:
        trans = get_translation(cds[mod3(-g.frame):], gcode)
        prefix = "# protein sequence = ["
        linelength = 100
        i = linelength - len(prefix)
        out.append(prefix + trans[:i] + ("]" if i >= len(trans) else ""))
        while i < len(trans):
            chunk = trans[i: i + linelength - 2]
            i += linelength - 2
            out.append("# " + chunk + ("]" if i >= len(trans) else ""))


def print_gene_list(agl: List[AltGene], codes: np.ndarray, o: OutputOptions,
                    gcode: genetics.GeneticCode,
                    with_evidence: bool = False,
                    seq_offset: int = 0) -> str:
    out: List[str] = []
    for ag in agl:
        out.append(f"# start gene {ag.id}")
        score = fmt3(ag.apostprob) if ag.has_probs else "."
        out.append(f"{ag.seqname}\tAUGUSTUS\tgene\t{ag.min_trans_begin() + 1}"
                   f"\t{ag.max_trans_end() + 1}\t{score}\t{ag.strand}\t.\t"
                   f"{'ID=' if o.gff3 else ''}{ag.id}")
        for tx in ag.transcripts:
            score = fmt3(tx.apostprob) if tx.has_probs else "."
            tid = f"{ag.id}.{tx.id}"
            idattr = (f"ID={tid};Parent={ag.id}" if o.gff3 else tid)
            kind = "transcript" if tx.coding else "noncoding_transcript"
            out.append(f"{ag.seqname}\tAUGUSTUS\t{kind}\t"
                       f"{tx.gene_begin() + 1}\t{tx.gene_end() + 1}\t{score}"
                       f"\t{tx.strand}\t.\t{idattr}")
            print_gene_gff(tx, o, out)
            if not tx.coding:
                continue
            print_sequences(tx, codes, o, gcode, out, seq_offset)
            if with_evidence:
                from . import evidence as ev
                ev.print_evidence(tx, out)
        out.append(f"# end gene {ag.id}")
        out.append("###")
    return "\n".join(out) + ("\n" if out else "")
