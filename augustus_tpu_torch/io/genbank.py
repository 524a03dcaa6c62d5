"""GenBank flat-file reader for annotated training sequences.

Port of `augustus_tpu/io/genbank.py`.

Behavioral equivalent of the reference GBSplitter/GBProcessor/GBFeature
(src/genbank.cc): records split at ``//``, a ``source 1..N`` line fixes the
sequence length, ``CDS``/``mRNA`` features carry join/complement coordinate
lists plus an optional ``/gene="..."`` tag, and the ORIGIN block holds the
sequence.  Produces :class:`AnnoSeq` objects with :class:`TGene` annotation
(training/annotation.py).
"""

from __future__ import annotations

import re
import sys
from typing import List, Optional, Tuple

from ..training.annotation import AnnoSeq, TGene
from .fasta import open_text


class GenBankError(Exception):
    pass


def detect_format(path: str) -> str:
    """'genbank' if the file has LOCUS and ORIGIN lines, else 'fasta'
    (reference GBSplitter::determineFileType, src/genbank.cc:585); a
    gzipped file is read as the FASTA reader reads it."""
    have_locus = have_origin = False
    with open_text(path) as fh:
        for line in fh:
            s = line.lstrip()
            if s.startswith("LOCUS"):
                have_locus = True
            elif have_locus and s.startswith("ORIGIN"):
                have_origin = True
                break
    return "genbank" if (have_locus and have_origin) else "fasta"


class _Feature:
    """One CDS/mRNA feature (reference GBFeature, src/genbank.cc:370)."""

    def __init__(self, fkey: str, lines: List[str]):
        self.fkey = fkey
        self.geneid = ""
        self.complete_l = True
        self.complete_r = True
        self.ranges: List[Tuple[int, int]] = []
        head = lines[0].split(None, 1)[1] if len(lines[0].split(None, 1)) > 1 \
            else ""
        # continuation lines of the location (joined ranges can wrap);
        # qualifier lines start with '/'
        loc = head
        rest_idx = 1
        while rest_idx < len(lines):
            s = lines[rest_idx].strip()
            if s.startswith("/"):
                break
            loc += s
            rest_idx += 1
        self.strand = "-" if "complement" in loc else "+"
        nums = re.sub(r"[^\d.,<>]", "", loc)
        for part in [p for p in nums.split(",") if p]:
            if part.startswith("<"):
                self.complete_l = False
                part = part[1:]
            m = re.match(r"(\d+)\.\.(>?)(\d+)$", part)
            if m is None:
                mm = re.match(r"(\d+)$", part)   # single-base range
                if mm is None:
                    raise GenBankError("Wrong format for coordinates: " + loc)
                b = e = int(mm.group(1))
            else:
                b, e = int(m.group(1)), int(m.group(3))
                if m.group(2) == ">":
                    self.complete_r = False
            if b < 1 or e < 1:
                raise GenBankError("Wrong format for coordinates: " + loc)
            if b > e:
                raise GenBankError("Feature begins after it ends: " + loc)
            self.ranges.append((b - 1, e - 1))
        # the gene name: scan following qualifier lines that are indented by
        # 21 spaces until /gene= is found or indentation ends
        # (reference src/genbank.cc:437-452)
        for line in lines[1:]:
            if not line.startswith(" " * 21):
                break
            g = line.find("/gene=")
            if g >= 0:
                tail = line[g + 7:]
                self.geneid = tail.split('"')[0]
                break

    @property
    def begin(self) -> int:
        return min(b for b, _ in self.ranges) if self.ranges else -1

    @property
    def end(self) -> int:
        return max(e for _, e in self.ranges) if self.ranges else -1

    def check_range(self, seqlen: int) -> bool:
        return 0 <= self.begin and 0 <= self.end < seqlen


def _parse_record(text: str, with_utr: bool, stop_excluded: bool,
                  verbosity: int = 1) -> Optional[AnnoSeq]:
    lines = text.split("\n")
    seqname = "unknown"
    seqlength = 0
    cds: List[_Feature] = []
    mrna: List[_Feature] = []
    seq_parts: List[str] = []
    i = 0
    nlines = len(lines)
    while i < nlines:
        line = lines[i]
        s = line.strip()
        if s.startswith("LOCUS"):
            toks = s.split()
            if len(toks) > 1:
                seqname = toks[1][:99]
        elif s.startswith("source") and s.split()[0] == "source":
            m = re.search(r"(\d+)\.\.(\d+)", s)
            if m is None:
                raise GenBankError("Syntax error in source line: " + s)
            ln = int(m.group(2)) - int(m.group(1)) + 1
            if ln > seqlength:
                seqlength = ln
        elif s.startswith("CDS ") or s == "CDS":
            block = [line]
            j = i + 1
            while j < nlines and lines[j].startswith(" " * 21):
                block.append(lines[j])
                j += 1
            try:
                f = _Feature("CDS", block)
                if f.check_range(seqlength):
                    cds.append(f)
            except GenBankError as e:
                raise GenBankError(str(e))
        elif s.startswith("mRNA ") or s == "mRNA":
            block = [line]
            j = i + 1
            while j < nlines and lines[j].startswith(" " * 21):
                block.append(lines[j])
                j += 1
            try:
                f = _Feature("mRNA", block)
                if f.check_range(seqlength):
                    mrna.append(f)
            except GenBankError:
                pass
        elif s.startswith("ORIGIN"):
            # sequence lines follow: "NUMBER bases..." until end of record
            for k in range(i + 1, nlines):
                seq_parts.append(re.sub(r"[^A-Za-z]", "",
                                        lines[k].lstrip(" 0123456789")))
            break
        i += 1

    if seqlength == 0:
        raise GenBankError(
            "Sequence has 0 length. Maybe 'source' Feature missing?")
    sequence = "".join(seq_parts)
    if len(sequence) > seqlength:
        raise GenBankError("Sequence was longer than the expected %d bp."
                           % seqlength)
    if len(sequence) < seqlength:
        seqlength = len(sequence)

    anno = AnnoSeq(seqname=seqname, sequence=sequence)
    # genes from CDS features (reference GBProcessor::getAnnoSequence,
    # src/genbank.cc:96-226)
    cds.sort(key=lambda f: (f.begin, f.end))
    mrna.sort(key=lambda f: (f.begin, f.end))
    lastgeneend = -1
    cur_gene_nr = 1
    for f in cds:
        if f.begin <= lastgeneend:
            continue   # overlapping CDS ignored
        g = TGene()
        g.geneid = f.geneid if f.geneid else "%s-%d" % (seqname, cur_gene_nr)
        g.seqname = seqname
        g.strand = f.strand
        g.exons = list(f.ranges)
        if stop_excluded and g.exons:
            if f.strand == "+":
                b, e = g.exons[-1]
                g.exons[-1] = (b, e + 3)
            else:
                b, e = g.exons[0]
                g.exons[0] = (b - 3, e)
            if g.exons[0][0] < 0 or g.exons[-1][1] >= seqlength:
                raise GenBankError(
                    "Stop codon out of sequence bounds. Ignoring sequence.")
        g.clength = sum(e - b + 1 for b, e in g.exons)
        g.codingstart = g.exons[0][0]
        g.codingend = g.exons[-1][1]
        for (pb, pe), (nb, ne) in zip(g.exons, g.exons[1:]):
            if pe + 1 > nb - 1:
                raise GenBankError("Intron has non-positive length.")
            g.introns.append((pe + 1, nb - 1))
        if with_utr:
            matched = None
            keep = []
            for mf in mrna:
                if _matches(f, mf):
                    if matched is None:
                        matched = mf
                else:
                    keep.append(mf)
            mrna = keep
            if matched is not None:
                g.add_utr(matched.ranges, matched.complete_l,
                          matched.complete_r)
        anno.genes.append(g)
        lastgeneend = f.end
        cur_gene_nr += 1
    anno.genes.sort(key=lambda g: (g.gene_begin(), g.gene_end()))
    return anno


def _matches(cds_f: _Feature, mrna_f: _Feature) -> bool:
    """mRNA extends CDS: identical internal boundaries (reference
    GBFeature::matches, src/genbank.cc:515)."""
    if cds_f.geneid and mrna_f.geneid and cds_f.geneid != mrna_f.geneid:
        return False
    if cds_f.strand != mrna_f.strand:
        return False
    st = cds_f.ranges
    ot = mrna_f.ranges
    if not st or not ot:
        return False
    j = 0
    while j < len(ot) and ot[j][1] < st[0][1]:
        j += 1
    if j >= len(ot):
        return False
    if not (ot[j][0] <= st[0][0] and
            (ot[j][1] == st[0][1] or
             (len(st) == 1 and ot[j][1] >= st[0][1]))):
        return False
    i = 0
    while j + 1 < len(ot) and i + 1 < len(st):
        i += 1
        j += 1
        internal = not (i == len(st) - 1 or i == 0)
        if internal and st[i] != ot[j]:
            return False
    if i < len(st) - 1:
        return False
    if not (ot[j][1] >= st[i][1] and
            (ot[j][0] == st[i][0] or (i == 0 and ot[j][0] <= st[i][0]))):
        return False
    return True


def read_genbank(path: str, with_utr: bool = False,
                 stop_excluded: bool = False) -> List[AnnoSeq]:
    """All annotated sequences of a GenBank flat file (reference
    GBProcessor::getAnnoSequenceList, src/genbank.cc:292)."""
    with open(path) as fh:
        data = fh.read()
    out: List[AnnoSeq] = []
    for rec in data.split("\n//"):
        if not rec.strip():
            continue
        try:
            anno = _parse_record(rec, with_utr, stop_excluded)
        except GenBankError as e:
            print("GBProcessor: %s" % e, file=sys.stderr)
            continue
        if anno is not None:
            out.append(anno)
    if not out:
        raise GenBankError("No genbank sequences found.")
    return out
