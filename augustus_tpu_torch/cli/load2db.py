"""load2db CLI (reference src/load2db.cc) — MySQL genome/hint loader.

Usage: python -m augustus_tpu_torch.cli.load2db --species=NAME \
           --dbaccess=dbname,host,user,passwd[,port] \
           [--chunksize=50000] input.fa|input.gff

Needs a MySQL DB-API module (pymysql / MySQLdb / mysql.connector); the
SQLite equivalent (cli.load2sqlitedb) has no external dependency.

Host copy of `augustus_tpu/cli/load2db.py`: the same argv grammar, output
text, exit codes and statements; it runs no kernel.
"""

from __future__ import annotations

import sys

from ..cgp.mysql_db import CHUNKSIZE, load2db


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
            "usage: load2db --species=NAME "
            "--dbaccess=dbname,host,user,passwd[,port] "
            "[--chunksize=N] input.fa|input.gff\n")
        return 1
    for path in inputs:
        n = load2db(db, species, path, chunksize=chunksize)
        kind = "hints" if path.lower().endswith((".gff", ".gff3", ".gtf")) \
            else "genome chunks"
        print(f"loaded {n} {kind} for {species}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
