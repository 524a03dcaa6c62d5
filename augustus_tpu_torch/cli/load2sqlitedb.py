"""load2sqlitedb CLI (reference src/load2sqlitedb.cc).

Usage: python -m augustus_tpu_torch.cli.load2sqlitedb --species=NAME \
           --dbaccess=DB.db [--chunksize=50000] input.fa|input.gff

Host copy of `augustus_tpu/cli/load2sqlitedb.py`: the same argv grammar,
output text, exit codes and store tables; it runs no kernel.
"""

from __future__ import annotations

import sys

from ..cgp.sqlite_db import CHUNKSIZE, load2sqlitedb, load_hints2sqlitedb


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    species = db = None
    chunksize = CHUNKSIZE
    inputs = []
    for a in argv:
        if a.startswith("--species="):
            species = a.split("=", 1)[1]
        elif a.startswith("--dbaccess="):
            db = a.split("=", 1)[1]
        elif a.startswith("--chunksize="):
            chunksize = int(a.split("=", 1)[1])
        elif not a.startswith("--"):
            inputs.append(a)
    if not species or not db or not inputs:
        sys.stderr.write(
            "usage: load2sqlitedb --species=NAME --dbaccess=DB.db "
            "[--chunksize=N] input.fa|input.gff\n")
        return 1
    for path in inputs:
        low = path.lower()
        if low.endswith((".gff", ".gff3", ".gtf")):
            n = load_hints2sqlitedb(db, species, path)
            print(f"loaded {n} hints for {species} into {db}")
        else:
            n = load2sqlitedb(db, species, path, chunksize=chunksize)
            print(f"loaded {n} genome chunks for {species} into {db}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
