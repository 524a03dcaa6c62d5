"""SQLite-backed random sequence/hint access for CGP.

Reference: src/sqliteDB.cc (schema), src/load2sqlitedb.cc (loader CLI)
and SQLiteAccess (src/randseqaccess.cc:753) — the cluster-shared-store
mode where many CGP jobs read genome chunks and hints from one database
file instead of loading whole genomes into RAM.

Schema follows the reference's speciesnames / seqnames / genomes / hints
tables; one deliberate difference: the reference's SQLite `genomes` rows
store byte offsets into the original FASTA files (the DNA stays on
disk), while here the chunk text is stored in the database itself (as
the reference's MySQL variant does, randseqaccess.cc:415) — the database
is then self-contained, which is what a multi-host object-store layout
wants.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Dict, List, Optional

from .. import genetics
from ..io.fasta import read_fasta

CHUNKSIZE = 50000     # load2sqlitedb default (-c)


def load2sqlitedb(dbfile: str, species: str, fasta_path: str,
                  chunksize: int = CHUNKSIZE) -> int:
    """Load a genome FASTA into the database (reference load2sqlitedb).

    Returns the number of chunks written.  Case is preserved
    (softmasking)."""
    con = sqlite3.connect(dbfile)
    cur = con.cursor()
    cur.executescript("""
        CREATE TABLE IF NOT EXISTS speciesnames (
            speciesid INTEGER PRIMARY KEY AUTOINCREMENT,
            speciesname TEXT UNIQUE NOT NULL);
        CREATE TABLE IF NOT EXISTS seqnames (
            seqnr INTEGER PRIMARY KEY AUTOINCREMENT,
            speciesid INTEGER NOT NULL REFERENCES speciesnames(speciesid),
            seqname TEXT NOT NULL,
            UNIQUE(speciesid,seqname));
        CREATE TABLE IF NOT EXISTS genomes (
            seqid INTEGER PRIMARY KEY AUTOINCREMENT,
            seqnr INTEGER NOT NULL,
            speciesid INTEGER NOT NULL,
            start INTEGER NOT NULL,
            end INTEGER NOT NULL,
            dnaseq TEXT NOT NULL);
        CREATE TABLE IF NOT EXISTS hints (
            hintid INTEGER PRIMARY KEY AUTOINCREMENT,
            speciesid INTEGER NOT NULL,
            seqnr INTEGER NOT NULL,
            source TEXT,
            start INTEGER NOT NULL,
            end INTEGER NOT NULL,
            score REAL DEFAULT 0.0,
            type TEXT NOT NULL,
            strand TEXT DEFAULT '.',
            frame TEXT DEFAULT '.',
            priority INTEGER DEFAULT -1,
            grp TEXT DEFAULT '',
            mult INTEGER DEFAULT 1,
            esource TEXT NOT NULL);
        CREATE INDEX IF NOT EXISTS gidx
            ON genomes(speciesid, seqnr, start);
    """)
    cur.execute("INSERT OR IGNORE INTO speciesnames (speciesname) "
                "VALUES (?)", (species,))
    cur.execute("SELECT speciesid FROM speciesnames WHERE speciesname=?",
                (species,))
    spid = cur.fetchone()[0]
    nchunks = 0
    for rec in read_fasta(fasta_path):
        cur.execute("INSERT OR IGNORE INTO seqnames (speciesid, seqname)"
                    " VALUES (?, ?)", (spid, rec.name))
        cur.execute("SELECT seqnr FROM seqnames WHERE speciesid=? AND "
                    "seqname=?", (spid, rec.name))
        seqnr = cur.fetchone()[0]
        cur.execute("DELETE FROM genomes WHERE speciesid=? AND seqnr=?",
                    (spid, seqnr))
        seq = rec.sequence
        for off in range(0, len(seq), chunksize):
            chunk = seq[off: off + chunksize]
            cur.execute(
                "INSERT INTO genomes (seqnr, speciesid, start, end, "
                "dnaseq) VALUES (?, ?, ?, ?, ?)",
                (seqnr, spid, off, off + len(chunk) - 1, chunk))
            nchunks += 1
    con.commit()
    con.close()
    return nchunks


def load_hints2sqlitedb(dbfile: str, species: str, gff_path: str) -> int:
    """Load a hints GFF for one species (load2sqlitedb with a .gff)."""
    con = sqlite3.connect(dbfile)
    cur = con.cursor()
    cur.execute("SELECT speciesid FROM speciesnames WHERE speciesname=?",
                (species,))
    row = cur.fetchone()
    if row is None:
        raise KeyError(f"species {species} not in database")
    spid = row[0]
    n = 0
    with open(gff_path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            cur.execute("SELECT seqnr FROM seqnames WHERE speciesid=? "
                        "AND seqname=?", (spid, f[0]))
            row = cur.fetchone()
            if row is None:
                continue
            attrs = dict()
            for kv in f[8].replace("=", " ").split(";"):
                parts = kv.split()
                if len(parts) >= 2:
                    attrs[parts[0]] = parts[1]
            cur.execute(
                "INSERT INTO hints (speciesid, seqnr, source, start, end,"
                " score, type, strand, frame, priority, grp, mult,"
                " esource) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (spid, row[0], f[1], int(f[3]), int(f[4]),
                 float(f[5]) if f[5] != "." else 0.0, f[2], f[6], f[7],
                 int(attrs.get("priority", attrs.get("pri", -1))),
                 attrs.get("group", attrs.get("grp", "")),
                 int(attrs.get("mult", 1)),
                 attrs.get("source", attrs.get("src", "M"))))
            n += 1
    con.commit()
    con.close()
    return n


class SQLiteAccess:
    """RandSeqAccess backed by the chunked SQLite store — same interface
    as MemSeqAccess (reference SQLiteAccess, randseqaccess.hh:164)."""

    def __init__(self, dbfile: str, tbl_path: Optional[str] = None):
        if not os.path.exists(dbfile):
            raise FileNotFoundError(dbfile)
        self.con = sqlite3.connect(dbfile)
        self._species: List[str] = [
            r[0] for r in self.con.execute(
                "SELECT speciesname FROM speciesnames "
                "ORDER BY speciesid")]
        if tbl_path:
            # --speciesfilenames may restrict/order the species list
            order = []
            with open(tbl_path) as fh:
                for line in fh:
                    parts = line.split()
                    if parts and parts[0] in self._species:
                        order.append(parts[0])
            if order:
                self._species = order

    def species(self) -> List[str]:
        return list(self._species)

    def _ids(self, species: str, seqid: str):
        row = self.con.execute(
            "SELECT s.speciesid, n.seqnr FROM speciesnames s, seqnames n"
            " WHERE s.speciesid = n.speciesid AND s.speciesname=? AND"
            " n.seqname=?", (species, seqid)).fetchone()
        if row is None:
            rows = self.con.execute(
                "SELECT s.speciesid, n.seqnr FROM speciesnames s,"
                " seqnames n WHERE s.speciesid = n.speciesid AND"
                " s.speciesname=?", (species,)).fetchall()
            if len(rows) == 1:     # MAF seqid aliasing (cf. MemSeqAccess)
                return rows[0]
            raise KeyError(f"{species}.{seqid} not found")
        return row

    def seq_len(self, species: str, seqid: str) -> int:
        spid, seqnr = self._ids(species, seqid)
        row = self.con.execute(
            "SELECT MAX(end) FROM genomes WHERE speciesid=? AND seqnr=?",
            (spid, seqnr)).fetchone()
        return (row[0] or -1) + 1

    def get_seq(self, species: str, seqid: str, start: int, end: int,
                strand: str = "+") -> str:
        """Assemble [start, end] from overlapping chunks (reference
        SQLiteAccess::getSeq, randseqaccess.cc:753)."""
        spid, seqnr = self._ids(species, seqid)
        start = max(0, start)
        parts: List[str] = []
        pos = start
        for (cs, ce, dna) in self.con.execute(
                "SELECT start, end, dnaseq FROM genomes WHERE"
                " speciesid=? AND seqnr=? AND end>=? AND start<=?"
                " ORDER BY start", (spid, seqnr, start, end)):
            lo = max(pos, cs)
            hi = min(end, ce)
            if hi < lo:
                continue
            parts.append(dna[lo - cs: hi - cs + 1])
            pos = hi + 1
        s = "".join(parts)
        if strand == "-":
            s = genetics.decode(
                genetics.reverse_complement(genetics.encode(s)))
        return s

    def get_hints(self, species: str, seqid: str, start: int, end: int
                  ) -> List[tuple]:
        spid, seqnr = self._ids(species, seqid)
        return list(self.con.execute(
            "SELECT source, start, end, score, type, strand, frame,"
            " priority, grp, mult, esource FROM hints WHERE speciesid=?"
            " AND seqnr=? AND start<=? AND end>=?",
            (spid, seqnr, end, start)))
