"""Cluster chunking + merge: whole-genome scale without a cluster.

Reference: scripts/splitMfasta.pl (split a multi-FASTA at size
boundaries), scripts/createAugustusJoblist.pl (overlapping chunk job
lists) and scripts/join_aug_pred.pl (merge per-chunk GFFs, renumber
genes, drop duplicated boundary genes — join_aug_pred.pl:3-27).

Host copy of `augustus_tpu/pipeline/chunking.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional, Tuple

from ..io.fasta import FastaRecord, read_fasta


def split_mfasta(path: str, outdir: str, min_size: int = 1000000,
                 base: Optional[str] = None) -> List[str]:
    """Split a multi-FASTA into files of >= min_size bases (whole
    sequences; reference scripts/splitMfasta.pl)."""
    recs = read_fasta(path)
    if base is None:
        base = os.path.splitext(os.path.basename(path))[0]
    os.makedirs(outdir, exist_ok=True)
    out_files: List[str] = []
    cur: List[FastaRecord] = []
    cur_size = 0

    def flush():
        nonlocal cur, cur_size
        if not cur:
            return
        p = os.path.join(outdir, f"{base}.split.{len(out_files) + 1}.fa")
        with open(p, "w") as fh:
            for r in cur:
                fh.write(f">{r.name}\n")
                for i in range(0, len(r.sequence), 60):
                    fh.write(r.sequence[i:i + 60] + "\n")
        out_files.append(p)
        cur, cur_size = [], 0

    for r in recs:
        cur.append(r)
        cur_size += len(r.sequence)
        if cur_size >= min_size:
            flush()
    flush()
    return out_files


def make_joblist(path: str, chunk_size: int = 2500000,
                 overlap: int = 50000) -> List[Tuple[str, int, int]]:
    """Overlapping (seq, predictionStart, predictionEnd) chunks
    (reference scripts/createAugustusJoblist.pl --chunksize/--overlap)."""
    jobs = []
    for r in read_fasta(path):
        n = len(r.sequence)
        start = 0
        while True:
            end = min(start + chunk_size, n)
            jobs.append((r.name, start + 1, end))
            if end >= n:
                break
            start = end - overlap
    return jobs


_GENE_RE = re.compile(r"^# start gene (\S+)")
_TXID_RE = re.compile(r'(transcript_id ")([^"]+)(")')
_GID_RE = re.compile(r'(gene_id ")([^"]+)(")')


def join_aug_pred(chunks: List[str]) -> str:
    """Merge per-chunk prediction outputs (reference
    scripts/join_aug_pred.pl): keep chunk order, renumber genes g1..gN,
    and when two adjacent chunks predict an identical gene in their
    overlap, keep only the first copy."""
    out: List[str] = []
    seen_genes = set()        # (seq, begin, end, strand, CDS-chain)
    gnum = 0
    for text in chunks:
        lines = text.splitlines()
        i = 0
        while i < len(lines):
            line = lines[i]
            m = _GENE_RE.match(line)
            if not m:
                if not line.startswith("# command line") and \
                        not line.startswith("# Predicted genes") and \
                        not line.startswith("# ----- prediction"):
                    pass
                i += 1
                continue
            # collect the whole gene block
            block = []
            gid_old = m.group(1)
            while i < len(lines):
                block.append(lines[i])
                if lines[i].startswith("# end gene"):
                    break
                i += 1
            i += 1
            key_parts = []
            for bl in block:
                f = bl.split("\t")
                if len(f) >= 8 and f[2] in ("CDS", "gene"):
                    key_parts.append((f[0], f[2], f[3], f[4], f[6]))
            key = tuple(key_parts)
            if key in seen_genes:
                continue
            seen_genes.add(key)
            gnum += 1
            gid_new = f"g{gnum}"
            for bl in block:
                bl = bl.replace(f"gene {gid_old}", f"gene {gid_new}")
                bl = _TXID_RE.sub(
                    lambda mm: mm.group(1) +
                    mm.group(2).replace(gid_old + ".", gid_new + ".", 1) +
                    mm.group(3), bl)
                bl = _GID_RE.sub(
                    lambda mm: mm.group(1) + gid_new + mm.group(3), bl)
                f = bl.split("\t")
                if len(f) >= 9 and f[8] == gid_old:
                    f[8] = gid_new
                    bl = "\t".join(f)
                out.append(bl)
    return "\n".join(out) + ("\n" if out else "")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(
            "usage: python -m augustus_tpu_torch.pipeline.chunking "
            "join out1.gff out2.gff ... > joined.gff\n"
            "       python -m augustus_tpu_torch.pipeline.chunking "
            "split genome.fa outdir [minsize]\n")
        return 1
    if argv[0] == "join":
        sys.stdout.write(join_aug_pred([open(p).read() for p in argv[1:]]))
        return 0
    if argv[0] == "split":
        minsize = int(argv[3]) if len(argv) > 3 else 1000000
        for p in split_mfasta(argv[1], argv[2], minsize):
            print(p)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
