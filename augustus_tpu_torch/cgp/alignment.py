"""MAF multi-genome alignments for CGP.

Reference: src/alignment.cc (fragment / AlignmentRow / Alignment,
merging) and src/genomicMSA.cc (readAlignment :100, findGeneRanges :352).

An Alignment holds, per species, an AlignmentRow of gapless fragments
(chrPos, aliPos, len) in alignment columns; coordinate projection
genome<->alignment is binary search over fragments (reference
alignment.cc getAliPos/getGenomePos via liftover.hh templates).

findGeneRanges here is a deliberate simplification of the reference's
boost-graph path enumeration: alignments are chained along the reference
species' coordinates, merging neighbours whose gap is below maxGapLen and
capping ranges at maxRangeLen — the same effect (gene ranges covering the
aligned loci) without the MILP/path machinery.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class AlignmentRow:
    seqid: str                    # chromosome/scaffold name (without species)
    start: int                    # 0-based start on the + strand coordinate
    size: int                     # number of aligned (non-gap) bases
    strand: str                   # '+' or '-'
    src_size: int
    frags: List[Tuple[int, int, int]] = field(default_factory=list)
    # (chrPos on strand, aliCol, len)

    @property
    def end(self) -> int:
        return self.start + self.size

    def ali_pos(self, chr_pos: int) -> int:
        """alignment column of strand-coordinate chr_pos, or -1 if gapped
        (reference liftover projectToAli)."""
        i = bisect_right(self._starts(), chr_pos) - 1
        if i < 0:
            return -1
        c, a, l = self.frags[i]
        if chr_pos < c + l:
            return a + (chr_pos - c)
        return -1

    def genome_pos(self, ali_col: int) -> int:
        """strand coordinate at alignment column, or -1 in a gap."""
        i = bisect_right(self._acols(), ali_col) - 1
        if i < 0:
            return -1
        c, a, l = self.frags[i]
        if ali_col < a + l:
            return c + (ali_col - a)
        return -1

    def _starts(self):
        if not hasattr(self, "_st"):
            self._st = [f[0] for f in self.frags]
        return self._st

    def _acols(self):
        if not hasattr(self, "_ac"):
            self._ac = [f[1] for f in self.frags]
        return self._ac


@dataclass
class Alignment:
    ali_len: int
    rows: Dict[str, AlignmentRow]
    score: float = 0.0


def read_maf(path: str, species: Optional[List[str]] = None
             ) -> List[Alignment]:
    """Parse a MAF file into Alignment blocks (reference
    GenomicMSA::readAlignment, genomicMSA.cc:100)."""
    alis: List[Alignment] = []
    cur: List[Tuple[str, str, int, int, str, int, str]] = []
    score = 0.0

    def flush():
        nonlocal cur, score
        if not cur:
            return
        ali_len = len(cur[0][6].replace("\n", ""))
        rows = {}
        for (spec, seqid, start, size, strand, ssize, text) in cur:
            frags = []
            chr_pos, acol = start, 0
            run_c = run_a = -1
            run_len = 0
            for ch in text:
                if ch == "-":
                    if run_len:
                        frags.append((run_c, run_a, run_len))
                        run_len = 0
                else:
                    if not run_len:
                        run_c, run_a = chr_pos, acol
                    run_len += 1
                    chr_pos += 1
                acol += 1
            if run_len:
                frags.append((run_c, run_a, run_len))
            rows[spec] = AlignmentRow(seqid=seqid, start=start, size=size,
                                      strand=strand, src_size=ssize,
                                      frags=frags)
        alis.append(Alignment(ali_len=ali_len, rows=rows, score=score))
        cur = []

    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("a"):
                flush()
                score = 0.0
                for tok in line.split():
                    if tok.startswith("score="):
                        score = float(tok[6:])
            elif line.startswith("s"):
                parts = line.split()
                src = parts[1]
                if "." in src:
                    spec, seqid = src.split(".", 1)
                else:
                    spec, seqid = src, src
                if species is not None and spec not in species:
                    continue
                cur.append((spec, seqid, int(parts[2]), int(parts[3]),
                            parts[4], int(parts[5]), parts[6]))
            elif not line.strip():
                flush()
    flush()
    return alis


@dataclass
class GeneRange:
    """One gene range: per-species genomic intervals + member alignments
    (reference GeneMSA over an AliPath)."""
    alis: List[Alignment]
    intervals: Dict[str, Tuple[str, int, int, str]]   # spec -> (seqid, s, e, strand)


def find_gene_ranges(alis: List[Alignment], ref_species: str,
                     max_gap: int = 50000, max_range: int = 500000,
                     padding: int = 1000) -> List[GeneRange]:
    """Chain alignment blocks into gene ranges (reference
    GenomicMSA::findGeneRanges, genomicMSA.cc:352 — simplified to
    reference-species chaining; see module docstring)."""
    withref = [a for a in alis if ref_species in a.rows]
    withref.sort(key=lambda a: (a.rows[ref_species].seqid,
                                a.rows[ref_species].start))
    ranges: List[GeneRange] = []
    group: List[Alignment] = []

    def flush():
        if not group:
            return
        intervals: Dict[str, Tuple[str, int, int, str]] = {}
        for a in group:
            for spec, row in a.rows.items():
                cur = intervals.get(spec)
                if cur is None or cur[0] != row.seqid or cur[3] != row.strand:
                    if cur is None:
                        intervals[spec] = (row.seqid, row.start, row.end,
                                           row.strand)
                    continue
                intervals[spec] = (row.seqid, min(cur[1], row.start),
                                   max(cur[2], row.end), row.strand)
        # pad within the source sequences
        padded = {}
        for spec, (seqid, s, e, strand) in intervals.items():
            padded[spec] = (seqid, max(0, s - padding), e + padding, strand)
        ranges.append(GeneRange(alis=list(group), intervals=padded))
        group.clear()

    last_end = None
    last_chr = None
    for a in group_sorted(withref, ref_species):
        row = a.rows[ref_species]
        if group and (row.seqid != last_chr or
                      row.start - last_end > max_gap or
                      row.end - group[0].rows[ref_species].start > max_range):
            flush()
        group.append(a)
        last_end = max(last_end or 0, row.end) if group[1:] else row.end
        last_chr = row.seqid
    flush()
    return ranges


def group_sorted(alis: List[Alignment], ref: str) -> List[Alignment]:
    return sorted(alis, key=lambda a: (a.rows[ref].seqid,
                                       a.rows[ref].start, a.rows[ref].end))
