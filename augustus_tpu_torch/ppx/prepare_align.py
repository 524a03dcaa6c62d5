"""prepareAlign — clean an MSA so that block profiles can be built.

Reference: src/pp_prepare_align.cc.  A column is a candidate block
column when its non-gap ratio exceeds FULL_COL_WEIGHT (0.8) and "empty"
below SKIP_COL_WEIGHT (0.2); runs of at least MINSIZE (6) candidate
columns form blocks.  Sequences that conflict with block columns (gaps
inside blocks, or residues spanning empty regions that break the block
structure) are deleted greedily while the objective
`net block width x remaining sequences` grows — the same objective and
thresholds as the reference's iterative optimization (environment
overrides PA_FULL_COL_WEIGHT / PA_SKIP_COL_WEIGHT / PA_MINSIZE /
PA_MIN_COL_COUNT are honored).  Output: the cleaned MSA in FASTA.

Host copy of `augustus_tpu/ppx/prepare_align.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np

FULL_COL_WEIGHT = float(os.environ.get("PA_FULL_COL_WEIGHT", 0.8))
SKIP_COL_WEIGHT = float(os.environ.get("PA_SKIP_COL_WEIGHT", 0.2))
MINSIZE = int(os.environ.get("PA_MINSIZE", 6))
MIN_COL_COUNT = int(os.environ.get("PA_MIN_COL_COUNT", 0))


def _block_width(nongap: np.ndarray, keep: np.ndarray,
                 minsize: int = MINSIZE) -> int:
    """Net width of block-column runs (>= minsize consecutive full
    columns) over the kept sequences."""
    h = int(keep.sum())
    if h == 0:
        return 0
    ratio = nongap[keep].mean(axis=0)
    full = ratio >= FULL_COL_WEIGHT
    width = 0
    run = 0
    for f in full:
        if f:
            run += 1
        else:
            if run >= minsize:
                width += run
            run = 0
    if run >= minsize:
        width += run
    return width


def prepare_align(names: List[str], rows: List[str]
                  ) -> Tuple[List[str], List[str]]:
    """Greedy sequence deletion maximizing block area (reference
    cutAlignment objective: net_width * seq_count)."""
    height = len(rows)
    if height == 0:
        return names, rows
    width = len(rows[0])
    arr = np.array([[c for c in r.ljust(width, "-")] for r in rows])
    nongap = (arr != "-") & (arr != ".")

    # drop sequences with fewer than MIN_COL_COUNT residues
    keep = np.array([bool(nongap[i].sum() >= MIN_COL_COUNT)
                     for i in range(height)])

    while True:
        base = _block_width(nongap, keep) * int(keep.sum())
        best_gain, best_i = 0, -1
        for i in np.flatnonzero(keep):
            keep[i] = False
            cand = _block_width(nongap, keep) * int(keep.sum())
            keep[i] = True
            if cand - base > best_gain:
                best_gain, best_i = cand - base, int(i)
        if best_i < 0:
            break
        keep[best_i] = False
        sys.stderr.write(f"prepareAlign: deleting sequence "
                         f"{names[best_i]} (objective +{best_gain})\n")

    kept = np.flatnonzero(keep)
    # drop columns that are all-gap in the kept subset
    col_keep = nongap[kept].any(axis=0)
    out_rows = ["".join(arr[i][col_keep]) for i in kept]
    return [names[i] for i in kept], out_rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv and not argv[0].startswith("-") else None
    fh = open(path) if path else sys.stdin
    from .msa2prfl import read_msa
    names, rows = read_msa(fh)
    names, rows = prepare_align(names, rows)
    for n, r in zip(names, rows):
        sys.stdout.write(f">{n}\n")
        for i in range(0, len(r), 60):
            sys.stdout.write(r[i: i + 60] + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
