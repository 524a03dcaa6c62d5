"""MySQL-backed random sequence/hint access for CGP + the load2db loader.

Reference: src/load2db.cc (loader CLI, schema at load2db.cc:294-367) and
MysqlAccess (src/randseqaccess.cc:135-161, 415) — the cluster deployment
mode where many CGP jobs share one MySQL server instead of a SQLite file
or per-process RAM genomes.

The reference selects this mode when --dbaccess is a connection spec
"dbname,host,user,passwd[,port]" rather than a *.db file
(src/compgenepred.cc:94-127).  The schema here is the reference's
(speciesnames / seqnames / genomes / hints / featuretypes, MyISAM typed
columns translated to portable SQL), and the chunking (50 kb, 0-based
inclusive start/end) matches load2db.cc insertSeq.

Driver discovery: any installed DB-API MySQL driver works (pymysql,
MySQLdb, mysql.connector, in that order); none is required at import
time, and every entry point also takes an already-open DB-API
``connection`` — that is what the unit tests inject and what lets a
deployment reuse a pooled connection.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..io.fasta import read_fasta

CHUNKSIZE = 50000     # load2db default (-c), reference load2db.cc:385

# the reference's featuretypes enum order (load2db.cc:356-366)
FEATURE_TYPE_NAMES = [
    "start", "stop", "ass", "dss", "tss", "tts", "exonpart", "exon",
    "intronpart", "intron", "irpart", "CDS", "CDSpart", "UTR", "UTRpart",
    "nonexonpart", "genicpart"]

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS speciesnames (
        speciesid INTEGER PRIMARY KEY AUTO_INCREMENT,
        speciesname VARCHAR(50) UNIQUE)""",
    """CREATE TABLE IF NOT EXISTS seqnames (
        seqnr INTEGER PRIMARY KEY AUTO_INCREMENT,
        speciesid INTEGER,
        seqname VARCHAR(50),
        UNIQUE (speciesid, seqname))""",
    """CREATE TABLE IF NOT EXISTS genomes (
        seqid INTEGER PRIMARY KEY AUTO_INCREMENT,
        dnaseq LONGTEXT NOT NULL,
        seqnr INTEGER,
        start INTEGER NOT NULL,
        end INTEGER NOT NULL,
        speciesid INTEGER,
        KEY region (speciesid, seqnr, start, end))""",
    """CREATE TABLE IF NOT EXISTS hints (
        hintid INTEGER PRIMARY KEY AUTO_INCREMENT,
        speciesid INTEGER,
        seqnr INTEGER,
        source VARCHAR(50),
        start INTEGER NOT NULL,
        end INTEGER NOT NULL,
        score FLOAT NOT NULL DEFAULT 0.0,
        type INTEGER NOT NULL,
        strand VARCHAR(1) NOT NULL DEFAULT '.',
        frame VARCHAR(1) NOT NULL DEFAULT '.',
        priority INTEGER NOT NULL DEFAULT -1,
        grp VARCHAR(100) DEFAULT '',
        mult INTEGER DEFAULT 1,
        esource VARCHAR(10) NOT NULL,
        KEY region (speciesid, seqnr, start, end))""",
    """CREATE TABLE IF NOT EXISTS featuretypes (
        typeid INTEGER PRIMARY KEY,
        typename VARCHAR(20) NOT NULL)""",
]


def parse_dbaccess(dbaccess: str) -> Dict[str, object]:
    """Split the reference's "dbname,host,user,passwd[,port]" spec
    (src/randseqaccess.cc MysqlAccess::open)."""
    parts = [p.strip() for p in dbaccess.split(",")]
    if len(parts) < 4:
        raise ValueError(
            "MySQL dbaccess must be dbname,host,user,passwd[,port]; got "
            + repr(dbaccess))
    out: Dict[str, object] = {"db": parts[0], "host": parts[1],
                              "user": parts[2], "passwd": parts[3]}
    if len(parts) > 4 and parts[4]:
        out["port"] = int(parts[4])
    return out


def is_mysql_dbaccess(dbaccess: str) -> bool:
    """Reference dispatch rule (compgenepred.cc:94-127): *.db means
    SQLite, a comma-separated spec means MySQL."""
    return "," in dbaccess and not dbaccess.endswith(".db")


def connect(dbaccess: str):
    """Open a DB-API connection with whichever MySQL driver is
    installed."""
    cfg = parse_dbaccess(dbaccess)
    try:
        import pymysql
        return pymysql.connect(host=cfg["host"], user=cfg["user"],
                               password=cfg["passwd"], database=cfg["db"],
                               port=int(cfg.get("port", 3306)))
    except ImportError:
        pass
    try:
        import MySQLdb
        return MySQLdb.connect(host=cfg["host"], user=cfg["user"],
                               passwd=cfg["passwd"], db=cfg["db"],
                               port=int(cfg.get("port", 3306)))
    except ImportError:
        pass
    try:
        import mysql.connector
        return mysql.connector.connect(
            host=cfg["host"], user=cfg["user"], password=cfg["passwd"],
            database=cfg["db"], port=int(cfg.get("port", 3306)))
    except ImportError:
        pass
    raise RuntimeError(
        "No MySQL driver installed (tried pymysql, MySQLdb, "
        "mysql.connector); pass an open DB-API `connection` instead, or "
        "use the SQLite store (cgp/sqlite_db.py).")


def _exec(cur, sql: str, params: Tuple = ()):
    # normalize paramstyle: the schema/queries use %s (MySQL drivers);
    # sqlite3-style test doubles advertise qmark
    if getattr(cur, "paramstyle", None) == "qmark":
        sql = sql.replace("%s", "?")
    cur.execute(sql, params)
    return cur


def create_schema(con) -> None:
    cur = con.cursor()
    for stmt in _SCHEMA:
        cur.execute(stmt)
    for i, name in enumerate(FEATURE_TYPE_NAMES):
        _exec(cur, "INSERT IGNORE INTO featuretypes VALUES (%s, %s)",
              (i, name))
    con.commit()


def _species_id(cur, species: str, create: bool = False) -> Optional[int]:
    _exec(cur, "SELECT speciesid FROM speciesnames WHERE speciesname=%s",
          (species,))
    row = cur.fetchone()
    if row is not None:
        return row[0]
    if not create:
        return None
    _exec(cur, "INSERT INTO speciesnames (speciesname) VALUES (%s)",
          (species,))
    _exec(cur, "SELECT speciesid FROM speciesnames WHERE speciesname=%s",
          (species,))
    return cur.fetchone()[0]


def _seq_nr(cur, spid: int, seqname: str, create: bool = False
            ) -> Optional[int]:
    _exec(cur, "SELECT seqnr FROM seqnames WHERE speciesid=%s AND "
          "seqname=%s", (spid, seqname))
    row = cur.fetchone()
    if row is not None:
        return row[0]
    if not create:
        return None
    _exec(cur, "INSERT INTO seqnames (speciesid, seqname) VALUES (%s, %s)",
          (spid, seqname))
    _exec(cur, "SELECT seqnr FROM seqnames WHERE speciesid=%s AND "
          "seqname=%s", (spid, seqname))
    return cur.fetchone()[0]


def load2db(dbaccess_or_con, species: str, path: str,
            chunksize: int = CHUNKSIZE) -> int:
    """Load a genome FASTA or a hints GFF (reference load2db main):
    FASTA rows become 50 kb `genomes` chunks with 0-based inclusive
    start/end; GFF rows become `hints` rows with the featuretypes enum
    index.  Returns the number of rows inserted."""
    con = dbaccess_or_con if hasattr(dbaccess_or_con, "cursor") \
        else connect(dbaccess_or_con)
    create_schema(con)
    cur = con.cursor()
    lower = path.lower()
    n = 0
    if lower.endswith((".gff", ".gff3", ".gtf")):
        spid = _species_id(cur, species)
        if spid is None:
            raise KeyError(f"species {species} not in database")
        with open(path) as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 9 or f[2] not in FEATURE_TYPE_NAMES:
                    continue
                seqnr = _seq_nr(cur, spid, f[0])
                if seqnr is None:
                    continue
                attrs = {}
                for kv in f[8].replace("=", " ").split(";"):
                    parts = kv.split()
                    if len(parts) >= 2:
                        attrs[parts[0]] = parts[1]
                _exec(cur,
                      "INSERT INTO hints (speciesid, seqnr, source, "
                      "start, end, score, type, strand, frame, priority,"
                      " grp, mult, esource) VALUES (%s,%s,%s,%s,%s,%s,"
                      "%s,%s,%s,%s,%s,%s,%s)",
                      (spid, seqnr, f[1], int(f[3]), int(f[4]),
                       float(f[5]) if f[5] != "." else 0.0,
                       FEATURE_TYPE_NAMES.index(f[2]), f[6], f[7],
                       int(attrs.get("priority", attrs.get("pri", -1))),
                       attrs.get("group", attrs.get("grp", "")),
                       int(attrs.get("mult", 1)),
                       attrs.get("source", attrs.get("src", "M"))))
                n += 1
    else:
        spid = _species_id(cur, species, create=True)
        for rec in read_fasta(path):
            seqnr = _seq_nr(cur, spid, rec.name, create=True)
            _exec(cur, "DELETE FROM genomes WHERE speciesid=%s AND "
                  "seqnr=%s", (spid, seqnr))
            seq = rec.sequence
            for off in range(0, len(seq), chunksize):
                chunk = seq[off: off + chunksize]
                _exec(cur,
                      "INSERT INTO genomes (dnaseq, seqnr, start, end, "
                      "speciesid) VALUES (%s,%s,%s,%s,%s)",
                      (chunk, seqnr, off, off + len(chunk) - 1, spid))
                n += 1
    con.commit()
    return n


class MysqlAccess:
    """RandSeqAccess over MySQL (reference MysqlAccess,
    randseqaccess.cc:135-161,415): same get_seq/get_hints/seq_len surface
    as cgp.sqlite_db.SQLiteAccess so CompGenePred can swap stores."""

    def __init__(self, dbaccess: Optional[str] = None,
                 tbl_path: Optional[str] = None, connection=None):
        self.con = connection if connection is not None \
            else connect(dbaccess)
        self.tbl_path = tbl_path

    def _cur(self):
        return self.con.cursor()

    def species(self) -> List[str]:
        cur = self._cur()
        _exec(cur, "SELECT speciesname FROM speciesnames ORDER BY "
              "speciesid")
        return [r[0] for r in cur.fetchall()]

    def _ids(self, species: str, seqid: str):
        cur = self._cur()
        spid = _species_id(cur, species)
        if spid is None:
            raise KeyError(f"species {species} not in database")
        seqnr = _seq_nr(cur, spid, seqid)
        if seqnr is None:
            raise KeyError(f"sequence {seqid} of {species} not in "
                           "database")
        return spid, seqnr

    def seq_len(self, species: str, seqid: str) -> int:
        spid, seqnr = self._ids(species, seqid)
        cur = self._cur()
        _exec(cur, "SELECT MAX(end) FROM genomes WHERE speciesid=%s AND "
              "seqnr=%s", (spid, seqnr))
        row = cur.fetchone()
        return (row[0] + 1) if row and row[0] is not None else 0

    def get_seq(self, species: str, seqid: str, start: int, end: int
                ) -> str:
        """Sequence text for [start, end] 0-based inclusive, assembled
        from overlapping chunks (reference MysqlAccess::getSeq)."""
        spid, seqnr = self._ids(species, seqid)
        cur = self._cur()
        _exec(cur,
              "SELECT start, end, dnaseq FROM genomes WHERE speciesid=%s"
              " AND seqnr=%s AND start<=%s AND end>=%s ORDER BY start",
              (spid, seqnr, end, start))
        out = []
        for cstart, cend, dnaseq in cur.fetchall():
            lo = max(start, cstart)
            hi = min(end, cend)
            out.append(dnaseq[lo - cstart: hi - cstart + 1])
        return "".join(out)

    def get_hints(self, species: str, seqid: str, start: int, end: int
                  ) -> List[dict]:
        spid, seqnr = self._ids(species, seqid)
        cur = self._cur()
        _exec(cur,
              "SELECT source, start, end, score, type, strand, frame, "
              "priority, grp, mult, esource FROM hints WHERE "
              "speciesid=%s AND seqnr=%s AND start>=%s AND end<=%s "
              "ORDER BY start, end", (spid, seqnr, start, end))
        rows = []
        for r in cur.fetchall():
            rows.append({
                "source": r[0], "start": r[1], "end": r[2],
                "score": r[3], "type": FEATURE_TYPE_NAMES[r[4]],
                "strand": r[5], "frame": r[6], "priority": r[7],
                "group": r[8], "mult": r[9], "esource": r[10]})
        return rows
