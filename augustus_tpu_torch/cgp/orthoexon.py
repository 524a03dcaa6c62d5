"""Ortho-exon assembly: align exon candidates across species.

Reference: GeneMSA::createOrthoExons (src/geneMSA.cc:223) and OrthoExon
(src/orthoexon.cc): exon candidates whose boundaries project to the same
alignment columns (within a tolerance at both ends) form one ortho exon
("HECT"); each carries the presence/absence pattern over species that
the phylogenetic exon gain/loss model scores.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .alignment import GeneRange
from .exoncand import ExonCandidate


@dataclass
class OrthoExon:
    ali_key: Tuple[int, int, int, str]     # (aliStart, aliEnd, type, strand)
    members: Dict[str, ExonCandidate] = field(default_factory=dict)
    phylo_score: float = 0.0               # log-odds present-pattern vs null
    omega: float = -1.0                    # ML omega (dN/dS), codonevo.py
    post_omega: float = -1.0               # posterior-mean omega ("Eomega")
    subst: int = -1                        # Fitch substitution count
    ID: int = 0

    def pattern(self, species: List[str], aligned: Dict[str, bool]):
        """leaf states: 1 member, 0 aligned but absent, -1 unaligned."""
        out = []
        for s in species:
            if s in self.members:
                out.append(1)
            elif aligned.get(s, False):
                out.append(0)
            else:
                out.append(-1)
        return out


def _project(gr: GeneRange, spec: str, pos: int) -> int:
    """genome position (within the species' range interval, forward
    coords) -> alignment column; -1 if unaligned.  The gene range's
    alignment blocks are stacked: block i's columns are offset by the
    running total of preceding blocks' widths."""
    off = 0
    for a in gr.alis:
        row = a.rows.get(spec)
        if row is not None:
            p = row.ali_pos(pos)
            if p >= 0:
                return off + p
        off += a.ali_len
    return -1


def create_ortho_exons(gr: GeneRange,
                       cands: Dict[str, List[ExonCandidate]],
                       tolerance: int = 6) -> List[OrthoExon]:
    """Group candidates by projected boundary columns (reference
    geneMSA.cc:223; boundary tolerance mirrors the reference's leniency
    for alignment slop at exon ends)."""
    buckets: Dict[Tuple[int, int, int, str], OrthoExon] = {}
    for spec, lst in cands.items():
        _, lo, _, _ = gr.intervals[spec]
        for ec in lst:
            a0 = _project(gr, spec, lo + ec.begin)
            a1 = _project(gr, spec, lo + ec.end)
            if a0 < 0 or a1 < 0:
                continue
            key = (a0 // tolerance, a1 // tolerance, ec.etype, ec.strand)
            oe = buckets.get(key)
            if oe is None:
                oe = OrthoExon(ali_key=(a0, a1, ec.etype, ec.strand))
                buckets[key] = oe
            # keep the highest-scoring candidate per species
            cur = oe.members.get(spec)
            if cur is None or ec.score > cur.score:
                oe.members[spec] = ec
    # only tuples with >= 2 species carry comparative signal
    return [oe for oe in buckets.values() if len(oe.members) >= 2]


def species_aligned(gr: GeneRange) -> Dict[str, bool]:
    return {s: True for s in gr.intervals}
