"""Hint-generation converters, byte-verified against the reference Perl.

Ports of scripts/blat2hints.pl (PSL spliced alignments -> ep/intron
hints), scripts/wig2hints.pl (wiggle coverage -> CDSpart hints),
scripts/join_mult_hints.pl (merge identical hints, summing
multiplicity), scripts/filterSpliceHints.pl (keep pattern-consensus
introns), scripts/exonerate2hints.pl and scripts/polyA2hints.pl; the
transMap converter lives in pipeline/transmap2hints.py.  Each function
was diffed byte-for-byte against the corresponding Perl script on
synthetic and example inputs (see the round-4 commit messages for the
cases).

Host copy of `augustus_tpu/pipeline/hints_gen.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional

MIN_INTRON = 41        # blat2hints.pl defaults
MAX_INTRON = 350000
EP_CUTOFF = 10         # trim exonpart hints by this at both ends
MAX_GAP_LEN = 14       # gaps up to this length are tolerated inside exons


def psl_to_hints(lines: Iterable[str], source: str = "E",
                 priority: int = 4, min_intron: int = 41,
                 max_intron: int = 350000, max_gap: int = 14,
                 max_qgap: int = 5, ep_cutoff: int = 10,
                 min_endblock: int = 8, max_gene_len: int = 400000,
                 max_coverage: int = 3000, introns_only: bool = False,
                 mult: bool = True, score: float = 0.0) -> List[str]:
    """PSL -> hints GFF, mirroring scripts/blat2hints.pl's default path
    (no clone/terminus files, ssOn/trunkSS/remove_redundant off):
    blocks merge over gaps <= maxgaplen, re-open over intron-length gaps
    and drop the alignment otherwise; "ep" hints trim ep_cutoff from the
    outer ends (both for single-block alignments), terminal blocks must
    reach min_endblock_len; intron hints need the query gap <=
    maxQgaplen; hints flush per target with introns sorted and merged
    into mult counts; a 10bp-binned coverage cap drops alignments in
    over-covered regions.  Output verified byte-exact against the Perl
    script."""
    out: List[str] = []
    lists: Dict[str, list] = {k: [] for k in ("ep", "exon", "intron")}
    oldtarget = "no name yet"
    coverage: Dict[int, int] = {}

    def flush() -> None:
        intr = sorted(lists["intron"], key=lambda h: (h[0], h[1]))
        if mult:
            merged = []
            for h in intr:
                if merged and h[0] == merged[-1][0] and \
                        h[1] == merged[-1][1]:
                    merged[-1][5] += 1
                else:
                    merged.append(list(h))
            intr = merged
        lists["intron"] = intr
        for typ in ("ep", "exon", "intron"):
            for h in lists[typ]:
                attrs = f"grp={h[3]};" if h[5] == 1 else ""
                if h[4] != "":
                    attrs += f"cdna={h[4]};"
                if h[5] > 1:
                    attrs += f"mult={h[5]};"
                out.append(f"{oldtarget}\tb2h\t{typ}\t{h[0]}\t{h[1]}\t"
                           f"{score:g}\t{h[2]}\t.\t{attrs}"
                           f"pri={priority};src={source}")
            lists[typ] = []

    skip = 0
    for raw in lines:
        if "psLayout" in raw:
            skip = 5
        if skip > 0:
            skip -= 1
            continue
        line = raw
        if line.startswith("#"):
            continue
        if not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 20:
            continue
        qname = f[9]
        target = f[13]
        tstart, tend = int(f[15]), int(f[16]) - 1
        if tend - tstart + 1 > max_gene_len:
            continue
        if target != oldtarget:
            flush()
            coverage.clear()
        oldtarget = target
        if any(coverage.get(i, 0) >= max_coverage
               for i in range(tstart // 10, tend // 10 + 1)):
            continue
        for i in range(tstart // 10, tend // 10 + 1):
            coverage[i] = coverage.get(i, 0) + 1
        b = [int(x) for x in f[18].rstrip(", ").split(",") if x]
        q = [int(x) for x in f[19].rstrip(", ").split(",") if x]
        t = [int(x) for x in f[20].rstrip(", ").split(",") if x]
        begins: List[int] = []
        ends: List[int] = []
        folok: List[int] = []
        bad = False
        for i in range(len(t)):
            mstart = t[i] + 1
            mend = mstart + b[i] - 1
            gap = (mstart - ends[-1] - 1) if ends else min_intron
            qok = 1 if (i + 1 < len(t) and
                        q[i] + b[i] >= q[i + 1] - max_qgap) else 0
            if min_intron <= gap <= max_intron:
                begins.append(mstart)
                ends.append(mend)
                folok.append(qok)
            elif gap <= max_gap:
                ends[-1] = mend
                folok[-1] = qok
            else:
                bad = True
        if bad:
            continue
        nb = len(begins)
        grpname, cdnaname = qname, ""
        for i in range(nb):
            if i == 0 and i == nb - 1 and not introns_only:
                if begins[i] + 2 * ep_cutoff <= ends[i]:
                    lists["ep"].append([begins[i] + ep_cutoff,
                                        ends[i] - ep_cutoff, ".",
                                        grpname, cdnaname, 1])
            elif i == 0:
                if begins[i] + min_endblock - 1 <= ends[i]:
                    if begins[i] + ep_cutoff <= ends[i] and \
                            not introns_only:
                        lists["ep"].append([begins[i] + ep_cutoff,
                                            ends[i], ".", grpname,
                                            cdnaname, 1])
                    if folok[i] and (i < nb - 2 or
                                     ends[i + 1] - begins[i + 1] + 1
                                     > min_endblock):
                        lists["intron"].append([ends[i] + 1,
                                                begins[i + 1] - 1, ".",
                                                grpname, cdnaname, 1])
            elif i == nb - 1 and not introns_only:
                if ends[i] - min_endblock + 1 >= begins[i]:
                    if begins[i] <= ends[i] - ep_cutoff:
                        lists["ep"].append([begins[i],
                                            ends[i] - ep_cutoff, ".",
                                            grpname, cdnaname, 1])
            else:
                if not introns_only:
                    lists["exon"].append([begins[i], ends[i], ".",
                                          grpname, cdnaname, 1])
                if folok[i] and (i < nb - 2 or
                                 ends[i + 1] - begins[i + 1] + 1
                                 > min_endblock):
                    lists["intron"].append([ends[i] + 1,
                                            begins[i + 1] - 1, ".",
                                            grpname, cdnaname, 1])
    flush()
    return out


def join_mult_hints(lines: Iterable[str]) -> List[str]:
    """Merge identical hints, accumulating mult= (reference
    scripts/join_mult_hints.pl, streaming over sorted input).

    Groups run while (seq, type, start, end, strand, frame) equal the
    previous line, sub-bucketed by the src= attribute letter; a bucket
    with one hint passes through VERBATIM (the reference keeps its grp=
    and mult= untouched), multi-hint buckets get score column 6 set to
    the summed multiplicity and "mult=N;" prepended with the first
    hint's grp=/mult= stripped.  (The reference iterates buckets in perl
    hash order, nondeterministic when one position has several sources;
    here insertion order is used.)"""
    import re as _re
    out: List[str] = []
    last: Optional[List[str]] = None
    buckets: Dict[str, List[List[str]]] = {}

    def flush() -> None:
        for src, hs in buckets.items():
            if len(hs) == 1:
                out.append("\t".join(hs[0]).rstrip("\n"))
                continue
            mult = 0
            for h in hs:
                m = _re.search(r"mult=(\d+)", h[8])
                mult += int(m.group(1)) if m else 1
            h = list(hs[0])
            h[8] = _re.sub(r"gro?u?p=[^;]*;", "", h[8], count=1)
            h[8] = _re.sub(r"mult=\d+;", "", h[8], count=1)
            h[5] = str(mult)
            h[8] = f"mult={mult};" + h[8]
            out.append("\t".join(h).rstrip("\n"))
        buckets.clear()

    for line in lines:
        if not line.strip():
            continue
        f = line.split("\t")
        if len(f) < 9:
            continue
        m = _re.search(r"so?u?rce?=(\w)", f[8])
        src = m.group(1) if m else "no_src"
        if last is not None and not (
                f[0] == last[0] and f[2] == last[2] and
                int(f[3]) == int(last[3]) and int(f[4]) == int(last[4])
                and f[6] == last[6] and
                f[7].rstrip("\n") == last[7].rstrip("\n")):
            flush()
        last = f
        buckets.setdefault(src, []).append(f)
    if last is not None:
        flush()
    return out


def wig_to_hints(lines: Iterable[str], width: int = 40,
                 margin: int = 20, radius: float = 0.0,
                 minscore: float = 0.4, minthresh: float = 0.4,
                 typ: str = "CDSpart", prune: float = 0.0,
                 pri: Optional[int] = None, strand: str = ".",
                 src: str = "X") -> List[str]:
    """Wiggle scores -> CDSpart/exonpart hints, mirroring
    scripts/wig2hints.pl: contiguous runs >= minthresh are trimmed by
    `margin` (collapsing to the midpoint), optionally pruned where the
    boundary value is below prune*average, then covered by n=len/width
    centered sample points; each point's width-window average (to 3
    decimals) must exceed minscore and becomes one hint of +-radius
    around the point with mult=int(average).  Byte-exact vs the Perl
    script."""
    import re as _re
    out: List[str] = []
    values: List[float] = []
    offset = 0
    step = 1
    oldseq = ""
    MINCHUNK, MAXCHUNK = 1000000, 1100000

    def val(i: int) -> float:
        return values[i] if 0 <= i < len(values) and \
            values[i] is not None else 0.0

    def print_scores() -> None:
        nonlocal values, offset
        a = offset
        n_v = len(values)
        while a < n_v:
            while a < n_v and val(a) < minthresh:
                a += 1
            b = a
            while b < n_v and val(b) >= minthresh:
                b += 1
            b -= 1
            ap, bp = a + margin, b - margin
            if ap > bp:
                ap = bp = (ap + bp) // 2
            av = sum(val(j) for j in range(ap, bp + 1)) / (bp - ap + 1)
            while prune and prune * av > val(ap) and ap < bp:
                ap += 1
            while prune and prune * av > val(bp) and ap < bp:
                bp -= 1
            ln = bp - ap + 1
            n = max(1, ln // width)
            for i in range(n):
                m = int(ap + (ln - (n - 1) * width) / 2
                        + i * width + 0.5)
                w_av = sum(val(m + j - width // 2)
                           for j in range(width)) / width
                av_s = f"{w_av:.3f}"
                if float(av_s) > minscore:
                    frm = int(m - radius + 0.5)
                    to = int(m + radius + 0.5)
                    attrs = f"src={src};"
                    if pri is not None:
                        attrs += f"pri={pri};"
                    attrs += f"mult={int(float(av_s))};"
                    out.append(f"{oldseq}\tw2h\t{typ}\t{frm}\t{to}\t"
                               f"{av_s}\t{strand}\t.\t{attrs}")
            a = b + 1
        offset = a
        values = []

    for raw in lines:
        line = raw.rstrip("\n")
        m = _re.search(r"fixedStep chrom=(\S+)\s+start=(\d+) step=(\d+)",
                       line)
        if m:
            # perl order quirk preserved: the new header's start is
            # assigned BEFORE the per-sequence flush, which then resets
            # offset to 0 (wig2hints.pl:44-50)
            seq = m.group(1)
            offset = int(m.group(2))
            step = int(m.group(3))
            if seq != oldseq and oldseq != "":
                print_scores()
                offset = 0
            oldseq = seq
            continue
        m = _re.search(r"variableStep chrom=(\S+)", line)
        if m:
            seq = m.group(1)
            if seq != oldseq and oldseq != "":
                print_scores()
                offset = 0
            oldseq = seq
            continue
        m = _re.match(r"^([\.0-9]+)$", line)
        if m:
            v = float(m.group(1))
            while len(values) < offset + step:
                values.append(None)
            for i in range(step):
                values[offset + i] = v
            offset += step
            continue
        m = _re.match(r"^(\d+)\s*([\.0-9]+)$", line)
        if m:
            pos_, v = int(m.group(1)), float(m.group(2))
            while len(values) <= pos_:
                values.append(None)
            values[pos_] = v
            if (v < minthresh and pos_ > offset + MINCHUNK) or \
                    pos_ > offset + MAXCHUNK:
                print_scores()
    print_scores()
    return out


def exonerate_to_hints(lines: Iterable[str], minintronlen: int = 41,
                       maxintronlen: int = 350000,
                       cdspart_cutoff: int = 15, source: str = "XNT",
                       priority: int = 4) -> List[str]:
    """Exonerate protein2genome GFF dump -> intron/CDSpart hints
    (reference scripts/exonerate2hints.pl): `cds` features are trimmed by
    cdspart_cutoff at both ends (collapsing to the midpoint if they
    cross), `intron` features are kept within the length bounds, and the
    protein id from the `gene` line's `sequence <id> ;` attribute groups
    the hints."""
    import re
    out: List[str] = []
    prot = ""
    for raw in lines:
        line = raw.split("#")[0]
        if not line.strip():
            continue
        if "\texonerate:protein2genome:local\t" not in line:
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 8:
            continue
        seqname, typ = f[0], f[2]
        start, end = int(f[3]), int(f[4])
        score, strand = f[5], f[6]
        if end < start:
            start, end = end, start
        if typ == "intron":
            if minintronlen <= end - start + 1 <= maxintronlen:
                out.append(f"{seqname}\txnt2h\tintron\t{start}\t{end}\t"
                           f"{score}\t{strand}\t.\t"
                           f"src={source};grp={prot};pri={priority}")
        elif typ == "cds":
            start += cdspart_cutoff
            end -= cdspart_cutoff
            if start > end:
                start = end = (start + end) // 2
            out.append(f"{seqname}\txnt2h\tCDSpart\t{start}\t{end}\t"
                       f"{score}\t{strand}\t.\t"
                       f"src={source};grp={prot};pri={priority}")
        elif typ == "gene":
            m = re.search(r"sequence (\S+) ; ", line)
            if m:
                prot = m.group(1)
    return out


def polya_to_hints(lines: Iterable[str], hintradius: int = 10,
                   fmt: str = "old", swapstrand: bool = False,
                   source: str = "E", priority: int = 4) -> List[str]:
    """polyA/polyT site table -> tts hints (scripts/polyA2hints.pl):
    each 3' end becomes a tts hint of +-hintradius around the site;
    --swapstrand for polyT tables."""
    out: List[str] = []
    for raw in lines:
        if "Chromosome" in raw and "SeqName" in raw:
            continue
        f = raw.rstrip("\n").split("\t")
        if (fmt == "old" and len(f) < 26) or \
                (fmt == "new" and len(f) < 12) or \
                (fmt == "newer" and len(f) < 13):
            continue
        if fmt == "new":
            target, tts, strand = f[1], int(f[9]), f[2]
        elif fmt == "newer":
            target, tts, strand = f[2], int(f[10]), f[3]
        else:
            target, tts, strand = f[3], int(f[18]), f[2]
        qname = f[0]
        if swapstrand:
            strand = "-" if strand == "+" else "+"
        out.append(f"{target}\tpolyA\ttts\t{tts - hintradius}\t"
                   f"{tts + hintradius}\t.\t{strand}\t.\t"
                   f"pri={priority};src={source};est={qname}")
    return out


def filter_splice_hints(genome_path: str, hints_lines: Iterable[str],
                        pattern: str = "GTAG") -> List[str]:
    """scripts/filterSpliceHints.pl: keep intron hints whose boundary
    dinucleotides match the splice pattern (e.g. GTAG, GCAG) on either
    strand, rewriting the strand column accordingly."""
    import re as _re
    from ..io.fasta import read_fasta
    genomes = {r.name: r.sequence.upper() for r in
               read_fasta(genome_path)}
    out: List[str] = []
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    for line in hints_lines:
        gff = line.rstrip("\n").split("\t")
        if len(gff) < 9:
            continue
        seq = genomes.get(gff[0], "")
        a = seq[int(gff[3]) - 1: int(gff[3]) + 1]
        b = seq[int(gff[4]) - 2: int(gff[4])]
        given = a + b
        if _re.search(pattern, given):
            out.append("\t".join(gff[:6] + ["+"] + gff[7:9]))
        else:
            rc = given[::-1].translate(comp)
            if _re.search(pattern, rc):
                out.append("\t".join(gff[:6] + ["-"] + gff[7:9]))
    return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(
            "usage: python -m augustus_tpu_torch.pipeline.hints_gen "
            "{psl2hints|joinmult|wig2hints|exonerate2hints|polyA2hints}"
            " < in > out.gff\n")
        return 1
    lines = sys.stdin
    if argv[0] == "psl2hints":
        print("\n".join(psl_to_hints(lines)))
    elif argv[0] == "joinmult":
        print("\n".join(join_mult_hints(lines)))
    elif argv[0] == "wig2hints":
        print("\n".join(wig_to_hints(lines)))
    elif argv[0] == "exonerate2hints":
        print("\n".join(exonerate_to_hints(lines)))
    elif argv[0] == "polyA2hints":
        swap = "--swapstrand" in argv
        print("\n".join(polya_to_hints(lines, swapstrand=swap)))
    elif argv[0] == "filterSpliceHints" and len(argv) >= 3:
        pattern = argv[3] if len(argv) > 3 else "GTAG"
        print("\n".join(filter_splice_hints(argv[1], open(argv[2]),
                                            pattern)))
    else:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
