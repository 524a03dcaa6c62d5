"""Per-transcript hint evidence compilation and printing.

reference: Gene::compileExtrinsicEvidence / supportingFraction /
addSupportedStates / printEvidence / Evidence (src/gene.cc:1661-2300).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..hints.features import Feature, HintGroup
from .genes import Gene, PathState, fmt3


class Evidence:
    def __init__(self, with_names: bool):
        self.num = 0
        self.with_names = with_names
        self.sources: List[Tuple[str, int, List[str]]] = []  # ordered

    def add(self, source: str, name: str = "") -> None:
        for i, (src, freq, names) in enumerate(self.sources):
            if src == source:
                names.append(name)
                self.sources[i] = (src, freq + 1, names)
                self.num += 1
                return
        self.sources.append((source, 1, [name]))
        self.num += 1

    def print(self, out: List[str]) -> None:
        # reference Evidence::print: sort by source name; "# %6s:%4d " + names
        for src, freq, names in sorted(self.sources, key=lambda x: x[0]):
            line = f"# {src:>6}:{freq:>4} "
            listed = 0
            parts = []
            for nm in names:
                if listed >= 80:
                    break
                if nm:
                    parts.append(nm)
                    listed += len(nm) + 1
            if parts:
                line += "(" + ",".join(parts)
                if listed >= 80 or len(parts) < len([n for n in names if n]):
                    if listed >= 80:
                        line += ",..."
                line += ")"
            out.append(line.rstrip("\n"))
        return


def _frame_compatible_hint(state: PathState, hint: Feature) -> bool:
    # reference State::frame_compatible(Feature*): only CDSpart hints carry
    # frames in practice; hints without frame info are compatible
    return True


def supporting_fraction(g: Gene, group: HintGroup) -> float:
    """reference Gene::supportingFraction (gene.cc:1691)."""
    supporting = total = 0
    strand_plus = g.strand == "+"
    utr5 = g.utr5exons
    utr3 = g.utr3exons
    for hint in group.hints:
        t = hint.type
        supports = False
        if t == "genicpart" and g.gene_begin() <= hint.start and \
                g.gene_end() >= hint.end:
            supports = True
        for st in g.exons:
            if t in ("exon", "CDS") and hint.start == st.begin and \
                    hint.end == st.end:
                supports = True
            elif t in ("exonpart", "CDSpart") and hint.start >= st.begin and \
                    hint.end <= st.end and _frame_compatible_hint(st, hint):
                supports = True
        for st in g.introns:
            if t == "intron" and hint.start == st.begin and hint.end == st.end:
                supports = True
            elif t in ("intronpart", "nonexonpart") and \
                    hint.start >= st.begin and hint.end <= st.end:
                supports = True
            elif t in ("ass", "dss") and (
                    (hint.start <= st.begin <= hint.end) or
                    (hint.start <= st.end <= hint.end)):
                supports = True
        for utr in (utr5, utr3):
            last = None
            for i, st in enumerate(utr):
                if t in ("exon", "UTR") and hint.start == st.begin and \
                        hint.end == st.end:
                    supports = True
                elif t in ("exonpart", "UTRpart") and \
                        hint.start >= st.begin and hint.end <= st.end:
                    supports = True
                elif t in ("ass", "dss") and (
                        (i + 1 < len(utr) and
                         hint.start <= st.end + 1 <= hint.end) or
                        (i > 0 and hint.start <= st.begin - 1 <= hint.end)):
                    supports = True
                elif t == "intron" and last is not None and \
                        last.end + 1 == hint.start and \
                        st.begin - 1 == hint.end:
                    supports = True
                elif t in ("intronpart", "nonexonpart") and last is not None \
                        and last.end + 1 <= hint.start and \
                        st.begin - 1 >= hint.end:
                    supports = True
                last = st
        if t in ("exon", "exonpart"):
            last5 = utr5[-1] if utr5 else None
            last3 = utr3[-1] if utr3 else None
            exonbegin = exonend = -1
            if len(g.exons) == 1:
                if strand_plus and last5 is not None and utr3:
                    exonbegin, exonend = last5.begin, utr3[0].end
                if not strand_plus and last3 is not None and utr5:
                    exonbegin, exonend = last3.begin, utr5[0].end
            if strand_plus and last5 is not None and len(g.exons) > 1:
                exonbegin, exonend = last5.begin, g.exons[0].end
            if not strand_plus and len(g.exons) > 1 and utr5:
                exonbegin, exonend = g.exons[-1].begin, utr5[0].end
            if exonbegin > 0 and exonend > 0:
                if t == "exon" and hint.start == exonbegin and \
                        hint.end == exonend:
                    supports = True
                if t == "exonpart" and hint.start >= exonbegin and \
                        hint.end <= exonend:
                    supports = True
            if strand_plus and utr3 and g.exons:
                exonbegin, exonend = g.exons[-1].begin, utr3[0].end
            if not strand_plus and last3 is not None and g.exons:
                exonbegin, exonend = last3.begin, g.exons[0].end
            if exonbegin > 0 and exonend > 0:
                if t == "exon" and hint.start == exonbegin and \
                        hint.end == exonend:
                    supports = True
                if t == "exonpart" and hint.start >= exonbegin and \
                        hint.end <= exonend:
                    supports = True
        if t in ("exon", "exonpart", "CDS", "CDSpart", "intron", "intronpart",
                 "ass", "dss", "UTR", "UTRpart", "genicpart", "nonexonpart"):
            total += 1
            if supports:
                supporting += 1
    return supporting / total if total > 0 else 0.0


def _state_support(states: List[PathState], group: HintGroup, kind: str,
                   g: Gene, ev_map: Dict[int, set]) -> None:
    """addSupportedStates for one state list; ev_map collects source names
    per state identity."""
    hints = group.hints
    src = group.source
    strand_plus = g.strand == "+"
    for si, st in enumerate(states):
        supported = contradicted = False
        for hint in hints:
            t = hint.type
            if kind == "cds":
                if t in ("exon", "CDS") and hint.start == st.begin and \
                        hint.end == st.end:
                    supported = True
                elif t in ("exonpart", "CDSpart") and \
                        hint.start >= st.begin and hint.end <= st.end:
                    supported = True
                elif t in ("intronpart", "intron", "UTR", "UTRpart") and \
                        not (hint.start > st.end or hint.end < st.begin):
                    contradicted = True
                if si == 0 and t == "exon" and hint.end == st.end and \
                        hint.start < st.begin:
                    supported = True
                if si == 0 and t == "exonpart" and hint.end <= st.end and \
                        hint.end >= st.begin:
                    supported = True
                if si == len(states) - 1 and t == "exon" and \
                        hint.start == st.begin and hint.end >= st.end:
                    supported = True
                if si == len(states) - 1 and t == "exonpart" and \
                        hint.start <= st.end and hint.start >= st.begin:
                    supported = True
                if si == 0 and len(states) == 1 and \
                        t in ("exon", "exonpart") and \
                        hint.start <= st.begin and hint.end >= st.end:
                    supported = True
            elif kind == "intron":
                if t == "intron" and hint.start == st.begin and \
                        hint.end == st.end:
                    supported = True
                elif t == "intronpart" and hint.start >= st.begin and \
                        hint.end <= st.end:
                    supported = True
                elif t in ("exonpart", "exon", "UTR", "UTRpart") and \
                        not (hint.start > st.end or hint.end < st.begin):
                    contradicted = True
            elif kind in ("utr5", "utr3"):
                if t in ("exon", "UTR") and hint.start == st.begin and \
                        hint.end == st.end:
                    supported = True
                elif t in ("UTRpart", "exonpart") and \
                        hint.start >= st.begin and hint.end <= st.end:
                    supported = True
                elif t in ("intronpart", "intron", "CDS", "CDSpart") and \
                        not (hint.start > st.end or hint.end < st.begin):
                    contradicted = True
                if kind == "utr5":
                    if t == "exon" and ((strand_plus and si == len(states) - 1
                                         and hint.start == st.begin
                                         and hint.end >= st.end) or
                                        (not strand_plus and si == 0 and
                                         hint.end == st.end and
                                         hint.start <= st.begin)):
                        supported = True
                    if t == "exonpart" and (
                            (strand_plus and si == len(states) - 1 and
                             st.begin <= hint.start <= st.end) or
                            (not strand_plus and si == 0 and
                             st.begin <= hint.end <= st.end)):
                        supported = True
                else:
                    if t == "exon" and ((strand_plus and si == 0 and
                                         hint.end == st.end and
                                         hint.start <= st.end) or
                                        (not strand_plus and
                                         si == len(states) - 1 and
                                         hint.start == st.begin and
                                         hint.end >= st.end)):
                        supported = True
                    if t == "exonpart" and (
                            (strand_plus and si == 0 and
                             st.begin <= hint.end <= st.end) or
                            (not strand_plus and si == len(states) - 1 and
                             st.begin <= hint.start <= st.end)):
                        supported = True
        if supported and not contradicted:
            ev_map.setdefault((kind, si), []).append(src)


def compile_evidence(g: Gene, groups: List[HintGroup]) -> None:
    """Attach evidence summaries to the gene (reference
    compileExtrinsicEvidence)."""
    g.supporting_ev = Evidence(True)
    g.incompatible_ev = Evidence(True)
    ev_map: Dict[Tuple[str, int], List[str]] = {}
    # utr intron gaps
    g.utr5introns = [PathState(a.end + 1, b.begin - 1, g.utr5exons[0].type)
                     for a, b in zip(g.utr5exons, g.utr5exons[1:])]
    g.utr3introns = [PathState(a.end + 1, b.begin - 1, g.utr3exons[0].type)
                     for a, b in zip(g.utr3exons, g.utr3exons[1:])]
    for grp in groups:
        if grp.end < g.gene_begin() or grp.begin > g.gene_end():
            continue
        sf = supporting_fraction(g, grp)
        if sf >= 1.0:
            g.supporting_ev.add(grp.source, grp.name)
        else:
            g.incompatible_ev.add(grp.source, grp.name)
        _state_support(g.exons, grp, "cds", g, ev_map)
        _state_support(g.introns + g.utr5introns + g.utr3introns, grp,
                       "intron", g, ev_map)
        # NB: intron kinds share a single list in the reference loop; keep
        # index spaces separate for utr intron gaps
        _state_support(g.utr5exons, grp, "utr5", g, ev_map)
        _state_support(g.utr3exons, grp, "utr3", g, ev_map)

    def summary(kinds_counts):
        ev = Evidence(False)
        nstates_with = 0
        for kind, count in kinds_counts:
            for si in range(count):
                srcs = ev_map.get((kind, si), [])
                if srcs:
                    nstates_with += 1
                for src in srcs:
                    ev.add(src)
        ev.num = nstates_with
        return ev

    ncds_intron = len(g.introns)
    nutr5i = len(g.utr5introns)
    nutr3i = len(g.utr3introns)
    g.cds_exon_ev = summary([("cds", len(g.exons))])
    g.cds_intron_ev = summary([("intron", ncds_intron)])
    # utr intron evidence indexes continue after cds introns in the shared
    # "intron" kind space
    ev5 = Evidence(False)
    n5 = 0
    for si in range(ncds_intron, ncds_intron + nutr5i):
        srcs = ev_map.get(("intron", si), [])
        if srcs:
            n5 += 1
        for src in srcs:
            ev5.add(src)
    for si in range(len(g.utr5exons)):
        srcs = ev_map.get(("utr5", si), [])
        if srcs:
            n5 += 1
        for src in srcs:
            ev5.add(src)
    ev5.num = n5
    g.utr5_ev = ev5
    ev3 = Evidence(False)
    n3 = 0
    for si in range(ncds_intron + nutr5i, ncds_intron + nutr5i + nutr3i):
        srcs = ev_map.get(("intron", si), [])
        if srcs:
            n3 += 1
        for src in srcs:
            ev3.add(src)
    for si in range(len(g.utr3exons)):
        srcs = ev_map.get(("utr3", si), [])
        if srcs:
            n3 += 1
        for src in srcs:
            ev3.add(src)
    ev3.num = n3
    g.utr3_ev = ev3


def print_evidence(g: Gene, out: List[str]) -> None:
    """reference Gene::printEvidence (gene.cc:2420)."""
    out.append("# Evidence for and against this transcript:")
    ncds = len(g.exons)
    ncdsi = len(g.introns)
    n5 = len(g.utr5exons) + len(getattr(g, "utr5introns", []))
    n3 = len(g.utr3exons) + len(getattr(g, "utr3introns", []))
    n_states = ncds + ncdsi + n5 + n3
    num_sup = (g.cds_exon_ev.num + g.cds_intron_ev.num + g.utr5_ev.num
               + g.utr3_ev.num)
    pct = 100.0 * num_sup / n_states if n_states > 0 else 0.0
    out.append("# % of transcript supported by hints (any source): "
               + fmt3(pct))
    out.append(f"# CDS exons: {g.cds_exon_ev.num}/{ncds}")
    g.cds_exon_ev.print(out)
    out.append(f"# CDS introns: {g.cds_intron_ev.num}/{ncdsi}")
    g.cds_intron_ev.print(out)
    out.append(f"# 5'UTR exons and introns: {g.utr5_ev.num}/{n5}")
    g.utr5_ev.print(out)
    out.append(f"# 3'UTR exons and introns: {g.utr3_ev.num}/{n3}")
    g.utr3_ev.print(out)
    out.append(f"# hint groups fully obeyed: {g.supporting_ev.num}")
    g.supporting_ev.print(out)
    out.append(f"# incompatible hint groups: {g.incompatible_ev.num}")
    g.incompatible_ev.print(out)
