"""The full-size test sequences and the fixture hints.

`tiled_record(data_dir)` gives the >= 1,000,000-base sequence that
`chip_smoke.py` decodes on the card and whose prediction is committed as
`augustus_tpu_torch/data/golden/repo_fixture_tiled.gff`: the repository's
genomic sequences tiled between seeded uniform-ACGT spacers.
`tiled_hinted(data_dir)` gives the same letters, upper case with seeded
lower-case repeat runs, and the EST-style hints of every inserted gene
(golden `repo_fixture_tiled_hints.gff`).  `gene_hints` writes the hints of
one gene structure; `augustus_tpu_torch/data/make_hints_fixture.py` uses it
for the committed hint files.  `data_dir` is the repository's `tests/data`.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np

from .fasta import FastaRecord, read_fasta

TILED_LENGTH = 1_000_000
TILED_SEED = 7
TILED_NAME = "tiled"
TILED_HINTED_NAME = "tiled_sm"


def genbank_sequences(path: str) -> List[str]:
    """The ORIGIN sequences of a GenBank file (letters only)."""
    seqs, cur = [], None
    with open(path) as fh:
        for line in fh:
            if line.startswith("ORIGIN"):
                cur = []
            elif line.startswith("//"):
                if cur is not None:
                    seqs.append("".join(cur))
                cur = None
            elif cur is not None:
                cur.append("".join(ch for ch in line if ch.isalpha()))
    return seqs


def genbank_cds(path: str) -> List[Tuple[List[Tuple[int, int]], str]]:
    """(exons, strand) of the CDS feature of each GenBank record: 1-based
    inclusive (begin, end) pairs in ascending order."""
    out, cur = [], None
    with open(path) as fh:
        for line in fh:
            if line.startswith("     CDS "):
                cur = [line[21:].strip()]
            elif cur is not None and line.startswith(" " * 21) and \
                    not line[21:].lstrip().startswith("/"):
                cur.append(line[21:].strip())
            elif cur is not None:
                loc = "".join(cur)
                exons = [(int(a), int(b)) for a, b in
                         re.findall(r"(\d+)\.\.(\d+)", loc)]
                out.append((sorted(exons),
                            "-" if loc.startswith("complement") else "+"))
                cur = None
    return out


def golden_cds(path: str, seqname: str) -> List[Tuple[int, int]]:
    """The CDS exons of `seqname` in a GFF file (ascending, 1-based)."""
    exons = []
    with open(path) as fh:
        for line in fh:
            c = line.split("\t")
            if len(c) > 4 and c[0] == seqname and c[2] == "CDS":
                exons.append((int(c[3]), int(c[4])))
    return sorted(exons)


def _hint_line(seqname, ftype, a, b, strand, group=""):
    grp = f"grp={group};" if group else ""
    return (f"{seqname}\tb2h\t{ftype}\t{a}\t{b}\t0\t{strand}\t.\t"
            f"{grp}pri=4;src=E\n")


def gene_hints(exons: List[Tuple[int, int]], strand: str, seqname: str,
               group: str, seqlen: int, rng: np.random.Generator,
               with_signals: bool) -> List[str]:
    """EST-style GFF hints (src=E, pri=4) of one gene structure, in one
    hint group, plus about 20 % of hints placed off the structure.

    exons are 1-based inclusive and ascending.  On the structure: an intron
    hint per intron; exonpart on the inner part of each exon, every other
    exon split into two overlapping pieces (crossing depth 2); five short
    exonpart pieces with gaps on the longest exon (at least five parts
    inside one exon); CDSpart on every third exon; an exon hint on every
    other internal exon; a CDS hint on the middle exon; exon hints that
    reach 40 bases past the lowest and the highest exon (UTR-like); with
    `with_signals`, start, stop, dss and ass hints at the codons and at the
    intron ends."""
    lines: List[str] = []

    def add(ftype, a, b, st=strand, grp=group):
        if 1 <= a <= b <= seqlen:
            lines.append(_hint_line(seqname, ftype, a, b, st, grp))

    nex = len(exons)
    for i, (a, b) in enumerate(exons):
        ln = b - a + 1
        m = min(10, ln // 4)
        if ln >= 40 and i % 2 == 0:
            mid = (a + b) // 2
            add("exonpart", a + m, mid + 10)
            add("exonpart", mid - 10, b - m)
        elif ln >= 20:
            add("exonpart", a + m, b - m)
        if i % 3 == 1 and ln >= 30:
            add("CDSpart", a + m // 2 + 2, b - m // 2 - 2)
        if 0 < i < nex - 1 and i % 2 == 1:
            add("exon", a, b)
    a, b = max(exons, key=lambda e: e[1] - e[0])
    step = (b - a + 1) // 6
    if step >= 12:
        for k in range(5):
            add("exonpart", a + k * step + 4, a + (k + 1) * step - 4)
    for (_, b1), (a2, _) in zip(exons, exons[1:]):
        add("intron", b1 + 1, a2 - 1)
    add("CDS", *exons[nex // 2])
    add("exon", exons[0][0] - 40, exons[0][1])
    add("exon", exons[-1][0], exons[-1][1] + 40)
    if with_signals:
        # the codon and intron end that come first in transcription
        lo, hi = exons[0][0], exons[-1][1]
        first, last = ((lo, hi - 2) if strand == "+" else (hi - 2, lo))
        add("start", first, first + 2)
        add("stop", last, last + 2)
        for (_, b1), (a2, _) in zip(exons, exons[1:]):
            dss, ass = (b1 + 1, a2 - 1) if strand == "+" else (a2 - 1, b1 + 1)
            add("dss", dss, dss)
            add("ass", ass, ass)
    for _ in range((len(lines) + 2) // 4):
        ftype = ("exonpart", "intron", "CDSpart")[int(rng.integers(0, 3))]
        a = int(rng.integers(1, seqlen - 300))
        add(ftype, a, a + int(rng.integers(30, 301)),
            st="+-"[int(rng.integers(0, 2))], grp="")
    return lines


def mirror_hints(lines: List[str], seqname: str, seqlen: int) -> List[str]:
    """The hints of a sequence moved onto its reverse complement."""
    flip = {"+": "-", "-": "+", ".": "."}
    out = []
    for line in lines:
        c = line.split("\t")
        a, b = seqlen + 1 - int(c[4]), seqlen + 1 - int(c[3])
        out.append("\t".join([seqname, c[1], c[2], str(a), str(b), c[5],
                              flip[c[6]]] + c[7:]))
    return out


def _tiled_layout(data_dir: str):
    """The parts in order, each (offset, part sequence, its genes as
    [(exons, strand)]), and the tiled letters (lower case)."""
    parts = []
    golden = os.path.join(data_dir, "golden_human_mpe_hints.gff")
    for f in ("HS04636.fa", "HS08198.fa"):
        for r in read_fasta(os.path.join(data_dir, f)):
            parts.append((r.sequence, [(golden_cds(golden, r.name), "+")]))
    for f in ("genes_crf3.gb", "genes_test1.gb", "utrtrain.gb"):
        path = os.path.join(data_dir, f)
        parts += [(seq, [cds]) for seq, cds in
                  zip(genbank_sequences(path), genbank_cds(path))]
    rng = np.random.default_rng(TILED_SEED)
    acgt = np.frombuffer(b"acgt", dtype=np.uint8)
    out, layout, total, i = [], [], 0, 0
    while total < TILED_LENGTH:
        spacer = acgt[rng.integers(0, 4, int(rng.integers(2000, 20001)))]
        out.append(spacer.tobytes().decode())
        seq, genes = parts[i % len(parts)]
        layout.append((total + len(out[-1]), seq, genes))
        out.append(seq.lower())
        total += len(out[-2]) + len(out[-1])
        i += 1
    return layout, "".join(out)


def tiled_record(data_dir: str) -> FastaRecord:
    """HS04636.fa, HS08198.fa and the sequences of genes_crf3.gb,
    genes_test1.gb and utrtrain.gb, in turn, each after a spacer of 2-20 kb
    drawn from numpy.random.default_rng(TILED_SEED), until the total reaches
    TILED_LENGTH."""
    return FastaRecord(TILED_NAME, _tiled_layout(data_dir)[1])


def tiled_hinted(data_dir: str) -> Tuple[FastaRecord, List[str]]:
    """The letters of tiled_record, upper case with lower-case repeat runs
    of 100-3,000 bases about 2,300 bases apart (about 40 % of the sequence,
    as a RepeatMasker-softmasked vertebrate assembly), and the GFF hint
    lines of every inserted gene shifted into tiled coordinates; runs and
    off-structure hints from numpy.random.default_rng(TILED_SEED)."""
    layout, letters = _tiled_layout(data_dir)
    n = len(letters)
    rng = np.random.default_rng(TILED_SEED)
    seq = bytearray(letters.upper().encode())
    pos = int(rng.integers(100, 4551))
    while pos < n:
        end = min(pos + int(rng.integers(100, 3001)), n)
        seq[pos:end] = seq[pos:end].lower()
        pos = end + int(rng.integers(100, 4551))
    hints: List[str] = []
    for k, (off, part, genes) in enumerate(layout):
        for gi, (exons, strand) in enumerate(genes):
            lines = gene_hints(exons, strand, TILED_HINTED_NAME,
                               f"p{k}g{gi}", len(part), rng,
                               with_signals=k % 2 == 0)
            for line in lines:
                c = line.split("\t")
                c[3], c[4] = str(int(c[3]) + off), str(int(c[4]) + off)
                hints.append("\t".join(c))
    return FastaRecord(TILED_HINTED_NAME, seq.decode()), hints


EXON_HINT_TYPES = ("exonpart", "CDSpart", "exon", "CDS")


def exon_free_hints(lines: List[str]) -> List[str]:
    """The GFF hint lines without exonpart, CDSpart, exon and CDS hints:
    a hint set whose chunks take the device route (engine/device_prep.py)."""
    return [l for l in lines
            if l.startswith("#") or len(l.split("\t")) < 3
            or l.split("\t")[2] not in EXON_HINT_TYPES]
