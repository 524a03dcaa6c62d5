"""CGP helper tools: filterMaf and evalCGP.

Reference: scripts/filterMaf.pl (drop MAF blocks by species subset /
minimum sequence count / genomic interval) and scripts/evalCGP.pl
(evaluate a CGP prediction GTF against an annotation GTF on the genomic
intervals covered by the prediction, reporting gene/exon/nucleotide
sensitivity and specificity — the reference shells out to the external
Eval package; here the in-tree Evaluation engine computes the same
sens/spec levels).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple


def filter_maf(lines, species: Optional[List[str]] = None,
               min_seq: int = 2,
               interval: Optional[Tuple[str, int, int]] = None
               ) -> List[str]:
    """scripts/filterMaf.pl, streaming semantics preserved exactly:
    ##maf lines pass through; a block is kept when it retains at least
    `min_seq` s-lines after the species filter (substring/regex match on
    the full src field) and, with `interval`, when ANY of its s-lines
    overlaps (minus-strand coordinates flipped to forward); a kept block
    is printed with a trailing blank line when the NEXT block arrives,
    so the output ends blank-terminated only when the final input block
    was dropped."""
    import re
    out: List[str] = []
    block: List[str] = []
    overlap = False

    def flush(final: bool) -> None:
        nonlocal block, overlap
        if len(block) >= min_seq + 1 and overlap:
            out.extend(l.rstrip("\n") for l in block)
            if not final:
                out.append("")
        block = []
        overlap = False

    for raw in lines:
        line = raw if raw.endswith("\n") else raw + "\n"
        if "##maf" in line:
            out.append(line.rstrip("\n"))
        elif re.match(r"^a\s", line):
            flush(final=False)
            block.append(line)
        elif re.match(r"^s\s", line):
            f = re.split(r"\s+", line)
            seqid, start0, alen, strand, slen = \
                f[1], int(f[2]), int(f[3]), f[4], int(f[5])
            if strand == "-":
                start0 = slen - start0 - alen
            end_ = start0 + alen
            start1 = start0 + 1
            if species is None:
                block.append(line)
            else:
                for sp in species:
                    if re.search(sp, seqid):
                        block.append(line)
                        break
            if interval is None:
                overlap = True
            else:
                s_id, b_, e_ = interval
                if not (end_ < b_ or start1 > e_) and s_id == seqid:
                    overlap = True
    flush(final=True)
    return out


def _parse_gtf_genes(path: str):
    """CDS chains per transcript from a GTF/GFF file."""
    from ..output import genes as og
    from ..model.state_config import ST
    txs: Dict[str, og.Gene] = {}
    for raw in open(path):
        if raw.startswith("#") or not raw.strip():
            continue
        f = raw.rstrip("\n").split("\t")
        if len(f) < 9 or f[2] != "CDS":
            continue
        tid = None
        attrs = f[8]
        if "transcript_id" in attrs:
            tid = attrs.split("transcript_id")[1].split('"')[1]
        else:
            for kv in attrs.split(";"):
                if kv.strip().startswith(("ID=", "Parent=")):
                    tid = kv.split("=", 1)[1]
                    break
        if tid is None:
            tid = attrs.strip() or f"{f[0]}:{f[3]}"
        key = f"{f[0]}|{tid}"
        g = txs.get(key)
        if g is None:
            g = og.Gene()
            g.seqname = f[0]
            g.strand = f[6]
            g.id = tid
            txs[key] = g
        g.exons.append(og.PathState(int(f[3]) - 1, int(f[4]) - 1,
                                    ST.singleG))
    out = []
    for g in txs.values():
        g.exons.sort(key=lambda st: st.begin)
        g.codingstart = g.exons[0].begin
        g.codingend = g.exons[-1].end
        out.append(g)
    return out


def eval_cgp(anno_path: str, pred_path: str) -> Dict[str, float]:
    """scripts/evalCGP.pl: accuracy of a CGP prediction vs an annotation
    (gene / exon / nucleotide sensitivity+specificity), restricted to
    the sequences the prediction covers."""
    from ..output.evaluation import Evaluation
    anno = _parse_gtf_genes(anno_path)
    pred = _parse_gtf_genes(pred_path)
    pred_seqs = {g.seqname for g in pred}
    anno = [g for g in anno if g.seqname in pred_seqs]
    by_seq: Dict[str, Tuple[list, list]] = {}
    for g in anno:
        by_seq.setdefault(g.seqname, ([], []))[0].append(g)
    for g in pred:
        by_seq.setdefault(g.seqname, ([], []))[1].append(g)
    ev = Evaluation()
    for seq, (a, p) in by_seq.items():
        ev.add_to_evaluation(p, a, strand="both", quotient=0.0)
    lines: List[str] = []
    ev.finish(lines)
    res = {
        "gene_sens": ev.geneSens, "gene_spec": ev.geneSpec,
        "exon_sens": ev.exonSens, "exon_spec": ev.exonSpec,
        "nuc_sens": ev.nukSens, "nuc_spec": ev.nukSpec,
    }
    return {k: float(v) for k, v in res.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write("usage: python -m augustus_tpu_torch.cgp.helpers "
                         "{filtermaf|evalcgp} [options]\n")
        return 1
    if argv[0] == "filtermaf":
        species = None
        min_seq = 2
        interval = None
        for a in argv[1:]:
            if a.startswith("--species="):
                species = a.split("=", 1)[1].split(",")
            elif a.startswith("--min-seq"):
                min_seq = int(a.split("=", 1)[1]) if "=" in a else 2
            elif a.startswith("--interval="):
                spec = a.split("=", 1)[1]
                seqid, rng = spec.rsplit(":", 1)
                lo, hi = rng.split("-")
                interval = (seqid, int(lo), int(hi))
        print("\n".join(filter_maf(sys.stdin, species, min_seq,
                                   interval)))
        return 0
    if argv[0] == "evalcgp":
        anno = pred = None
        for a in argv[1:]:
            if a.startswith("--anno="):
                anno = a.split("=", 1)[1]
            elif a.startswith("--pred="):
                pred = a.split("=", 1)[1]
        res = eval_cgp(anno, pred)
        for k, v in res.items():
            print(f"{k}\t{v:.4f}")
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
