"""fastBlockSearch CLI (reference src/fastBlockSearch.cc).

Usage: python -m augustus_tpu_torch.cli.fastBlockSearch [--cutoff=x] \
           <seqs.fa> <fam.prfl>

Host copy of `augustus_tpu/cli/fastBlockSearch.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import math
import sys

from ..ppx.fastblock import format_results, search
from ..ppx.profile import Profile


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cutoff = 0.7
    consts = {}
    args = []
    pred_start = None
    pred_end = None
    for a in argv:
        if a.startswith("--"):
            if "=" not in a:
                sys.stderr.write("Usage: fastBlocksSearch [options] "
                                 "<seqs.fa> <fam.prfl>\n")
                return -1
            key, val = a[2:].split("=", 1)
            if key == "cutoff":
                cutoff = float(val)
            elif key == "avscore":
                cutoff = math.log(float(val))
            elif key == "predictionStart":
                pred_start = int(val) - 1
            elif key == "predictionEnd":
                pred_end = int(val)
            elif key.startswith("/ProteinModel/"):
                consts[key.rsplit("/", 1)[-1].replace(
                    "block_threshold_spec", "min_spec").replace(
                    "block_threshold_sens", "min_sens").replace(
                    "blockpart_threshold_spec", "partial_spec").replace(
                    "blockpart_threshold_sens", "partial_sens").replace(
                    "global_factor_threshold", "global_thresh")] = float(val)
        else:
            args.append(a)
    if len(args) != 2:
        sys.stderr.write("Usage: fastBlocksSearch [options] "
                         "<seqs.fa> <fam.prfl>\n")
        return -1

    prfl = Profile(args[1], consts=consts or None)
    col_count = sum(b.size for b in prfl.blocks)
    sys.stderr.write(f"Profile has {prfl.block_count()} blocks with "
                     f"{col_count} columns.\n")

    # reference reads sequences raw: header = full line after '>', body =
    # alphabetic chars lowercased (fastBlockSearch.cc:171-207)
    name = None
    seq_parts = []
    out = []

    def flush():
        if name is None:
            return
        seq = "".join(seq_parts)
        offset = 0
        if pred_start is not None or pred_end is not None:
            s = pred_start or 0
            e = pred_end if pred_end is not None else len(seq)
            seq = seq[s:e]
            offset = s
        groups = search(seq, prfl, cutoff=cutoff, offset=offset)
        out.append(format_results(name, groups))

    with open(args[0]) as fh:
        for line in fh:
            if line.startswith(">"):
                flush()
                name = line[1:].rstrip("\n")
                seq_parts = []
            else:
                seq_parts.append("".join(c.lower() for c in line
                                         if c.isalpha()))
    flush()
    sys.stdout.write("".join(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
