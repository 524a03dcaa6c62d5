"""Training-side gene annotation structures.

Port of `augustus_tpu/training/annotation.py`: lightweight equivalents of
the reference Gene/AnnoSequence (include/gene.hh), which the GenBank reader
(io/genbank.py) builds, and the split of a training set into single-gene
sequences; exons/introns are plain (begin, end) tuples in 0-based inclusive
coordinates, always kept in left-to-right order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_COMP = str.maketrans("acgtACGT", "tgcaTGCA")


def reverse_complement_str(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


@dataclass
class TGene:
    """One training transcript: coding exons + introns (+ optional UTR)."""
    geneid: str = ""
    id: str = "1"
    seqname: str = ""
    strand: str = "+"
    exons: List[Tuple[int, int]] = field(default_factory=list)
    introns: List[Tuple[int, int]] = field(default_factory=list)
    utr5exons: List[Tuple[int, int]] = field(default_factory=list)
    utr3exons: List[Tuple[int, int]] = field(default_factory=list)
    utr5introns: List[Tuple[int, int]] = field(default_factory=list)
    utr3introns: List[Tuple[int, int]] = field(default_factory=list)
    clength: int = 0
    codingstart: int = -1
    codingend: int = -1
    transstart: int = -1
    transend: int = -1
    complete_l: bool = True     # 5' UTR complete
    complete_r: bool = True     # 3' UTR complete
    weight: int = 1

    def gene_begin(self) -> int:
        return self.transstart if self.transstart >= 0 else self.codingstart

    def gene_end(self) -> int:
        return self.transend if self.transend >= 0 else self.codingend

    def add_utr(self, mrna_ranges: List[Tuple[int, int]], complete_l: bool,
                complete_r: bool) -> None:
        """Split mRNA ranges into 5'/3' UTR around the CDS (reference
        Gene::addUTR, src/gene.cc:1563) for a forward-strand layout; strand
        interpretation happens on reverse complementation."""
        if not self.exons:
            return
        cs, ce = self.codingstart, self.codingend
        utr_left: List[Tuple[int, int]] = []
        utr_right: List[Tuple[int, int]] = []
        for (b, e) in mrna_ranges:
            if e < cs:
                utr_left.append((b, e))
            elif b <= cs <= e:
                if b < cs:
                    utr_left.append((b, cs - 1))
            if b > ce:
                utr_right.append((b, e))
            elif b <= ce <= e:
                if e > ce:
                    utr_right.append((ce + 1, e))
        if self.strand == "+":
            self.utr5exons = utr_left
            self.utr3exons = utr_right
        else:
            self.utr5exons = utr_right
            self.utr3exons = utr_left
        if mrna_ranges:
            self.transstart = min(b for b, _ in mrna_ranges + self.exons)
            self.transend = max(e for _, e in mrna_ranges + self.exons)
        self.complete_l = complete_l
        self.complete_r = complete_r
        for lst_name in ("utr5exons", "utr3exons"):
            lst = getattr(self, lst_name)
            intr = [(pe + 1, nb - 1) for (pb, pe), (nb, ne)
                    in zip(lst, lst[1:])]
            setattr(self, "utr5introns" if lst_name == "utr5exons"
                    else "utr3introns", intr)

    def shift(self, d: int) -> None:
        for name in ("exons", "introns", "utr5exons", "utr3exons",
                     "utr5introns", "utr3introns"):
            setattr(self, name,
                    [(b + d, e + d) for b, e in getattr(self, name)])
        if self.codingstart >= 0:
            self.codingstart += d
            self.codingend += d
        if self.transstart >= 0:
            self.transstart += d
            self.transend += d

    def reverse(self, endpos: int) -> None:
        """Mirror all coordinates: pos -> endpos - pos (reference
        reverseGeneSequence, src/gene.cc:3246)."""
        for name in ("exons", "introns", "utr5exons", "utr3exons",
                     "utr5introns", "utr3introns"):
            setattr(self, name,
                    sorted((endpos - e, endpos - b)
                           for b, e in getattr(self, name)))
        if self.codingstart >= 0:
            self.codingstart, self.codingend = \
                endpos - self.codingend, endpos - self.codingstart
        if self.transstart >= 0:
            self.transstart, self.transend = \
                endpos - self.transend, endpos - self.transstart
        self.utr5exons, self.utr3exons = self.utr3exons, self.utr5exons
        self.utr5introns, self.utr3introns = \
            self.utr3introns, self.utr5introns
        self.strand = "+" if self.strand == "-" else "-"


@dataclass
class AnnoSeq:
    """An annotated sequence (reference AnnoSequence, include/gene.hh:548)."""
    seqname: str
    sequence: str
    genes: List[TGene] = field(default_factory=list)
    weight: int = 1

    @property
    def length(self) -> int:
        return len(self.sequence)

    def base_freqs(self) -> Tuple[float, float, float, float]:
        """Relative (a,c,g,t) frequencies (reference BaseCount)."""
        s = self.sequence.lower()
        a, c, g, t = s.count("a"), s.count("c"), s.count("g"), s.count("t")
        tot = a + c + g + t
        if tot == 0:
            return (0.25, 0.25, 0.25, 0.25)
        return (a / tot, c / tot, g / tot, t / tot)


def split_to_single_gene_seqs(annoseqs: List[AnnoSeq],
                              padding: int = 10000) -> List[AnnoSeq]:
    """Split multi-gene sequences into single-gene forward-strand pieces
    (reference EHMMTraining::split2SingleGeneSeqs, src/etraining.cc:300)."""
    import sys
    out: List[AnnoSeq] = []
    for mas in annoseqs:
        if not mas.genes:
            continue
        piece_index = 0
        piece_begin = 0
        genes = mas.genes
        multi_gene = len(genes) > 1
        skipped = 0
        gi = 0
        while gi < len(genes):
            g = genes[gi]
            piece_index += 1
            gene_end = g.gene_end()
            gene_begin = g.gene_begin()
            if gene_end < 0:
                raise ValueError("Encountered gene without any exons: "
                                 + g.geneid)
            # find the next gene completely to the right of g
            piece_end = -1
            nxt = gi
            skipped -= 1
            while nxt < len(genes) and piece_end <= gene_end:
                nxt += 1
                skipped += 1
                if nxt < len(genes):
                    piece_end = (gene_end + genes[nxt].gene_begin()) // 2
                else:
                    piece_end = mas.length - 1

            window_begin = piece_begin
            if window_begin < gene_begin - padding:
                window_begin = gene_begin - padding
            window_end = piece_end
            if window_end > gene_end + padding:
                window_end = gene_end + padding

            new_name = ("%s.p%d" % (mas.seqname, piece_index)
                        if multi_gene else mas.seqname)
            new_seq = mas.sequence[window_begin: window_end + 1]
            ng = _clone_gene(g)
            ng.seqname = new_name
            ng.shift(-window_begin)
            nas = AnnoSeq(seqname=new_name, sequence=new_seq, genes=[ng])
            if g.strand == "-":
                nas.sequence = reverse_complement_str(new_seq)
                ng.reverse(len(new_seq) - 1)
            out.append(nas)
            piece_begin = piece_end + 1
            gi = nxt
        if skipped > 0:
            print("Skipped %d gene(s) because their transcribed regions were "
                  "overlapping in sequence %s" % (skipped, mas.seqname),
                  file=sys.stderr)
    return out


def _clone_gene(g: TGene) -> TGene:
    import copy
    return copy.deepcopy(g)
