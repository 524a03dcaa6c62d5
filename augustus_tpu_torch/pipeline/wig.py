"""Coverage wiggle tracks from alignments: bam2wig and aln2wig.

Reference: auxprogs/bam2wig/bam2wig.c (htslib pileup depth ->
variableStep wiggle; deletions/refskips do not count as coverage, and
the samtools pileup default mask excludes unmapped/secondary/qcfail/
duplicate reads) and auxprogs/aln2wig/aln2wig.c (PSL alignments ->
variableStep wiggle).

Host copy of `augustus_tpu/pipeline/wig.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Optional, TextIO

import numpy as np

from .bam import BamReader

# samtools pileup default exclusion mask: UNMAP|SECONDARY|QCFAIL|DUP
EXCLUDE_FLAGS = 0x4 | 0x100 | 0x200 | 0x400


def bam_to_wig(bam_path: str, out: TextIO,
               trackname: Optional[str] = None,
               region: Optional[str] = None) -> None:
    """auxprogs/bam2wig: per-base read depth as variableStep wiggle."""
    bam = BamReader(bam_path)
    name = trackname if trackname is not None else bam_path
    out.write(f"track name={name} type=wiggle_0\n")
    reg_tid = reg_beg = reg_end = None
    if region:
        parts = region.split(":")
        reg_tid = bam.ref_names.index(parts[0])
        if len(parts) > 1 and "-" in parts[1]:
            a, b = parts[1].split("-")
            reg_beg, reg_end = int(a) - 1, int(b)
    cov: Dict[int, np.ndarray] = {}
    for al in bam:
        if al.ref_id < 0 or (al.flag & EXCLUDE_FLAGS):
            continue
        if reg_tid is not None and al.ref_id != reg_tid:
            continue
        c = cov.get(al.ref_id)
        if c is None:
            c = np.zeros(bam.ref_lengths[al.ref_id] + 1, dtype=np.int64)
            cov[al.ref_id] = c
        pos = al.pos
        for (ln, op) in al.cigar:
            if op in "M=X":         # consumes ref + read -> coverage
                if pos < c.shape[0]:
                    c[pos] += 1
                    e = min(pos + ln, c.shape[0] - 1)
                    c[e] -= 1
                pos += ln
            elif op in "DN":        # del/refskip: no coverage
                pos += ln
    for tid in sorted(cov):
        depth = np.cumsum(cov[tid][:-1])
        if reg_beg is not None:
            mask = np.zeros_like(depth, dtype=bool)
            mask[reg_beg:reg_end] = True
            depth = np.where(mask, depth, 0)
        nz = np.flatnonzero(depth > 0)
        if nz.size == 0:
            continue
        out.write(f"variableStep chrom={bam.ref_names[tid]}\n")
        out.write("\n".join(f"{p + 1} {depth[p]}" for p in nz))
        out.write("\n")


def psl_to_wig(lines: Iterable[str], out: TextIO,
               trackname: str = "aln2wig") -> None:
    """auxprogs/aln2wig: PSL alignment blocks -> variableStep wiggle."""
    cov: Dict[str, np.ndarray] = {}
    sizes: Dict[str, int] = {}
    for raw in lines:
        f = raw.rstrip("\n").split("\t")
        if len(f) < 21 or not f[0].isdigit():
            continue
        tname, tsize = f[13], int(f[14])
        sizes[tname] = max(sizes.get(tname, 0), tsize)
        c = cov.get(tname)
        if c is None or c.shape[0] < tsize + 1:
            nc = np.zeros(tsize + 1, dtype=np.int64)
            if c is not None:
                nc[: c.shape[0]] += c
            cov[tname] = c = nc
        bsizes = [int(x) for x in f[18].rstrip(",").split(",")]
        tstarts = [int(x) for x in f[20].rstrip(",").split(",")]
        for ln, st in zip(bsizes, tstarts):
            c[st] += 1
            c[min(st + ln, c.shape[0] - 1)] -= 1
    out.write(f"track name={trackname} type=wiggle_0\n")
    for tname in cov:
        depth = np.cumsum(cov[tname][:-1])
        nz = np.flatnonzero(depth > 0)
        if nz.size == 0:
            continue
        out.write(f"variableStep chrom={tname}\n")
        out.write("\n".join(f"{p + 1} {depth[p]}" for p in nz))
        out.write("\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write("usage: python -m augustus_tpu_torch.pipeline.wig "
                         "{bam2wig [-t name] [-r region] in.bam |"
                         " aln2wig < in.psl}\n")
        return 1
    if argv[0] == "bam2wig":
        trackname = None
        region = None
        path = None
        it = iter(argv[1:])
        for a in it:
            if a == "-t":
                trackname = next(it)
            elif a == "-r":
                region = next(it)
            else:
                path = a
        if path is None:
            return 1
        bam_to_wig(path, sys.stdout, trackname, region)
        return 0
    if argv[0] == "aln2wig":
        psl_to_wig(sys.stdin, sys.stdout)
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
