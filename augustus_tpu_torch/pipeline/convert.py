"""Format conversion helpers.

Reference: scripts/gtf2gff.pl (GTF <-> GFF3 with feature reshaping) and
scripts/getAnnoFasta.pl (extract coding / protein FASTA from a
prediction output).

Host copy of `augustus_tpu/pipeline/convert.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys
from typing import Dict, List


def gtf_to_gff3(lines) -> List[str]:
    """GTF -> GFF3 (reference scripts/gtf2gff.pl --gff3): gene and
    transcript lines get ID attributes, features get ID/Parent
    (byte-exact vs the Perl script for gene/mRNA/CDS inputs; the Perl's
    per-transcript coordinate re-sorting of mixed feature types is not
    reproduced — features keep input order here)."""
    out: List[str] = []     # the reference prints no ##gff-version line
    counters: Dict[str, int] = {}
    for line in lines:
        if not line.strip() or line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 9:
            continue
        feat, attrs = f[2], f[8]
        tid = gid = None
        if 'transcript_id "' in attrs:
            tid = attrs.split('transcript_id "')[1].split('"')[0]
        if 'gene_id "' in attrs:
            gid = attrs.split('gene_id "')[1].split('"')[0]
        if feat == "gene":
            gid = gid or attrs.strip()
            f[8] = f"ID={gid};"
        elif feat in ("transcript", "mRNA"):
            tid = tid or attrs.strip()
            f[8] = f"ID={tid};Parent={gid or tid.rsplit('.', 1)[0]};"
            f[2] = "mRNA"
        else:
            if tid is None:
                continue
            counters[(tid, feat)] = counters.get((tid, feat), 0) + 1
            lab = feat.replace("_codon", "")   # perl: ID label 'start1'
            f[8] = (f"ID={tid}.{lab}{counters[(tid, feat)]};"
                    f"Parent={tid};")
        out.append("\t".join(f))
    return out


def get_anno_fasta(lines, kind: str = "protein") -> List[str]:
    """Extract the '# protein sequence = [...]' / coding sequences from a
    prediction output (reference scripts/getAnnoFasta.pl)."""
    out: List[str] = []
    tid = None
    collecting = False
    buf: List[str] = []
    tag = "# protein sequence = [" if kind == "protein" else \
        "# coding sequence = ["
    for line in lines:
        line = line.rstrip("\n")
        if "\ttranscript\t" in line:
            tid = line.split("\t")[-1]
        if line.startswith(tag):
            collecting = True
            buf = [line[len(tag):]]
        elif collecting:
            if line.startswith("# ") or line.startswith("#"):
                buf.append(line[2:] if line.startswith("# ") else line[1:])
            else:
                collecting = False
        if collecting and buf and buf[-1].endswith("]"):
            buf[-1] = buf[-1][:-1]
            out.append(f">{tid or 'seq'}")
            out.extend(buf)
            collecting = False
    return out


def gb_to_gff(path: str) -> List[str]:
    """GenBank annotation -> GFF lines (reference scripts/gb2gff)."""
    from ..io.genbank import read_genbank
    out: List[str] = []
    for a in read_genbank(path, with_utr=True):
        for gi, g in enumerate(a.genes, start=1):
            gid = g.geneid or f"g{gi}"
            out.append(f"{a.seqname}\tgb2gff\tgene\t"
                       f"{min(b for b, _ in g.exons) + 1}\t"
                       f"{max(e for _, e in g.exons) + 1}\t.\t"
                       f"{g.strand}\t.\t{gid}")
            for (b, e) in g.exons:
                out.append(f"{a.seqname}\tgb2gff\tCDS\t{b + 1}\t{e + 1}"
                           f"\t.\t{g.strand}\t.\t"
                           f"transcript_id \"{gid}.t1\"; "
                           f"gene_id \"{gid}\";")
    return out


def summarize_acgt(path: str) -> List[str]:
    """scripts/summarizeACGTcontent.pl: per-sequence base counts plus a
    summary with GC fraction."""
    from ..io.fasta import read_fasta
    out: List[str] = []
    tot = {k: 0 for k in "ACGTN"}
    tot["rest"] = 0
    for rec in read_fasta(path):
        seq = rec.sequence.upper()
        cnt = {k: seq.count(k) for k in "ACGTN"}
        rest = len(seq) - sum(cnt.values())
        for k in cnt:
            tot[k] += cnt[k]
        tot["rest"] += rest
        line = (f"{len(seq)} bases.\t{rec.name.split()[0]} BASE COUNT"
                f"     {cnt['A']} a   {cnt['C']} c  {cnt['G']} g   "
                f"{cnt['T']} t")
        if cnt["N"] > 0:
            line += f"   {cnt['N']} n"
        if rest > 0:
            line += f"   {rest} ?"
        out.append(line)
    s = tot["A"] + tot["C"] + tot["G"] + tot["T"]
    length = s + tot["N"] + tot["rest"]
    gc = (tot["C"] + tot["G"]) / s if s else 0.0
    line = (f"summary: BASE COUNT     {tot['A']} a   {tot['C']} c  "
            f"{tot['G']} g   {tot['T']} t")
    if tot["N"] > 0:
        line += f"   {tot['N']} n"
    if tot["rest"] > 0:
        line += f"   {tot['rest']} ?"
    out.append(line)
    out.append(f"total {length}bp")
    out.append(f"gc: {gc:.15g}%")     # perl default stringification
    return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("usage: python -m "
                         "augustus_tpu_torch.pipeline.convert "
                         "{gtf2gff3|getprot} < in > out | "
                         "{gb2gff|summarizeACGT} <file>\n")
        return 1
    if argv[0] == "gb2gff" and len(argv) > 1:
        print("\n".join(gb_to_gff(argv[1])))
        return 0
    if argv[0] == "summarizeACGT" and len(argv) > 1:
        print("\n".join(summarize_acgt(argv[1])))
        return 0
    if argv[0] == "gtf2gff3":
        print("\n".join(gtf_to_gff3(sys.stdin)))
        return 0
    if argv[0] == "getprot":
        print("\n".join(get_anno_fasta(sys.stdin)))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
