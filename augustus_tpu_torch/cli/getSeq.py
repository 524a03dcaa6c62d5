"""Retrieve a (sub)sequence from a genome collection.

Usage:
  python -m augustus_tpu_torch.cli.getSeq --species=SPECIES --seq=SEQUENCE \
      --dbaccess=dbname.db [--speciesfilenames=TBL] [--start=N] [--end=N] [--rc]
  python -m augustus_tpu_torch.cli.getSeq --species=SPECIES --seq=SEQUENCE \
      --speciesfilenames=TBL [--start=N] [--end=N] [--rc]

Reference: src/getSeq.cc (SQLite/MySQL RandSeqAccess front-end; this
framework supports the SQLite and flat-file access modes —
cgp/seq_access.py).  Coordinates are 1-based inclusive; --rc prints the
reverse complement.
"""

# Host copy of `augustus_tpu/cli/getSeq.py`: the same argv grammar,
# output text and exit codes (its usage is this module's docstring); it
# runs no kernel.

from __future__ import annotations

import sys

FOLD = 60


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = {}
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
        elif a == "--rc":
            opts["rc"] = "1"
        elif a in ("--help", "-h"):
            sys.stderr.write(__doc__ + "\n")
            return 0
    species = opts.get("species")
    seqname = opts.get("seq")
    if not species or not seqname:
        sys.stderr.write(__doc__ + "\n")
        return 1
    start = int(opts.get("start", 1))
    end = int(opts.get("end", 0))

    dba = opts.get("dbaccess")
    tbl = opts.get("speciesfilenames")
    if dba:
        from ..cgp.sqlite_db import SQLiteAccess
        acc = SQLiteAccess(dba, tbl)
    elif tbl:
        from ..cgp.seq_access import MemSeqAccess
        acc = MemSeqAccess(tbl)
    else:
        sys.stderr.write("one of --dbaccess / --speciesfilenames needed\n")
        return 1
    if end <= 0:
        end = acc.seq_len(species, seqname)
    try:
        seq = acc.get_seq(species, seqname, start - 1, end - 1, "+")
    except KeyError:
        sys.stderr.write(f"sequence {seqname} not found for {species}\n")
        return 1
    if "rc" in opts:
        # case-preserving reverse complement (case carries softmasking)
        seq = seq[::-1].translate(
            str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))
    sys.stdout.write(f">{seqname} {start}..{end}\n")
    for i in range(0, len(seq), FOLD):
        sys.stdout.write(seq[i: i + FOLD] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
