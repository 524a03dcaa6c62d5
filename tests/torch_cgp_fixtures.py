"""The seeded input of comparative gene prediction (cgp/, --alnfile),
written by plain Python and numpy (neither package is imported here), for
tests/test_torch_cgp.py, the cgp goldens (tests/torch_goldens.py) and
chip_smoke.py's cgp cell.

Three "species" of two sequences each:
  hs      the first REF_LEN bases of tests/data/HS04636.fa and of
          tests/data/HS08198.fa;
  mutB    a seeded copy of hs: substitutions (SUB_RATE), small insertions
          and deletions of 1-3 bases (INDEL_RATE);
  mutC    another seeded copy, with the same kinds of mutation and with
          one exon of repo_fixture's golden gene on HS04636 deleted
          (DELETED_EXON).

write_cgp(dst) writes the genomes (FASTA), the alignment they were made
with as a MAF (ALN_SPANS of each hs sequence, one block each, mutB and
mutC rows with their gaps), a Newick tree, the species-file table, and an
SQLite store of the three genomes (load_store: through the package
`pkg`'s cgp.sqlite_db.load2sqlitedb, with chunks of SQL_CHUNK bases, and
hints for hs through load_hints2sqlitedb, or through its command line
cli/load2sqlitedb.py with the same arguments).  Every file is a function
of the seed (numpy's RandomState, whose stream is fixed across numpy
versions).

store_tables reads every table of a store in rowid order; fasta_letters
reads a FASTA file; getseq_text is getSeq's output for a slice of a
sequence, folded from the letters; and
write_mysql_stub writes a stand-in `pymysql` module (a recording DB-API
double over SQLite) for the load2db command lines.
"""

import contextlib
import importlib
import io
import os
import sqlite3
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CGP_SEED = 20162
SPECIES = ("hs", "mutB", "mutC")
REF_LEN = {"HS04636": 1800, "HS08198": 1900}
# the aligned span of each hs sequence (0-based, end exclusive): the
# gene ranges are these plus 1,000 bases of padding on either side
ALN_SPANS = {"HS04636": (700, 1300), "HS08198": (900, 1300)}
SUB_RATE = 0.03
INDEL_RATE = 0.004
# repo_fixture's first gene on HS04636.fa (its golden GFF): the exon
# 853-1163, 1-based, deleted in mutC
DELETED_EXON = ("HS04636", 852, 1163)
SQL_CHUNK = 1000
TREE = "((hs:0.08,mutB:0.1):0.05,mutC:0.12);\n"
HINTS = (("HS04636", "exonpart", 900, 1000, "+"),
         ("HS04636", "intron", 1164, 1500, "+"),
         ("HS08198", "exonpart", 700, 760, "-"))


def _read(name: str) -> str:
    with open(os.path.join(DATA, name + ".fa")) as fh:
        return "".join(l.strip() for l in fh if not l.startswith(">"))


def reference_genome() -> dict:
    """{seqid: letters} of hs."""
    out = {}
    for name, n in REF_LEN.items():
        s = _read(name)
        out[name] = s[:n]
    return out


def _aligned(seq: str, rng, span, delete=None):
    """A seeded copy of seq: (copy, where its row over span starts in the
    copy, the row's columns [(reference letter or '-', copy letter or
    '-')] over span).  Each base is deleted with INDEL_RATE / 2, preceded
    by an insertion of 1-3 bases with INDEL_RATE / 2 and substituted with
    SUB_RATE; the bases of `delete` are dropped."""
    bases = "ACGT"
    out, cols, start, at = [], [], None, 0
    for i, ch in enumerate(seq):
        inside = span[0] <= i < span[1]
        if i == span[0]:
            start = at
        if delete is not None and delete[0] <= i < delete[1]:
            if inside:
                cols.append((ch, "-"))
            continue
        r = rng.rand()
        if r < INDEL_RATE / 2:
            if inside:
                cols.append((ch, "-"))
            continue
        if r < INDEL_RATE:
            ins = "".join(bases[k] for k in rng.randint(
                0, 4, rng.randint(1, 4)))
            out.append(ins)
            at += len(ins)
            if inside:
                cols.extend(("-", c) for c in ins)
        c = ch
        if rng.rand() < SUB_RATE and ch.upper() in bases:
            c = bases[(bases.index(ch.upper()) + rng.randint(1, 4)) % 4]
            c = c.lower() if ch.islower() else c
        out.append(c)
        at += 1
        if inside:
            cols.append((ch, c))
    return "".join(out), start, cols


def genomes(seed: int = CGP_SEED, seqids=None):
    """({species: {seqid: letters}}, {seqid: MAF block rows}): the rows of
    each sequence's block as (species, start, size, text); only the hs
    sequences `seqids` when given (each sequence draws from its own
    stream, so a subset gives the same letters)."""
    ref = reference_genome()
    out = {"hs": dict(ref), "mutB": {}, "mutC": {}}
    blocks = {}
    for k, (seqid, seq) in enumerate(ref.items()):
        if seqids is not None and seqid not in seqids:
            del out["hs"][seqid]
            continue
        rng = np.random.RandomState(seed + k)
        span = ALN_SPANS[seqid]
        rows, starts = {}, {"hs": span[0]}
        for spec in ("mutB", "mutC"):
            delete = None
            if spec == "mutC" and seqid == DELETED_EXON[0]:
                delete = DELETED_EXON[1:]
            out[spec][seqid], starts[spec], rows[spec] = _aligned(
                seq, rng, span, delete)
        texts = _columns(seq, span, rows)
        blocks[seqid] = [(s, starts[s], sum(c != "-" for c in texts[s]),
                          texts[s]) for s in SPECIES]
    return out, blocks


def _columns(seq, span, rows):
    """{species: row text} of one sequence's block: the copies' columns
    merged with the reference's (an insertion of one copy is a gap in the
    other two rows)."""
    texts = {"hs": [], "mutB": [], "mutC": []}
    it = {s: iter(rows[s]) for s in rows}
    pend = {s: next(it[s], None) for s in rows}
    for i in range(span[0], span[1]):
        for s in ("mutB", "mutC"):
            while pend[s] is not None and pend[s][0] == "-":
                for t in texts:
                    texts[t].append(pend[s][1] if t == s else "-")
                pend[s] = next(it[s], None)
        texts["hs"].append(seq[i])
        for s in ("mutB", "mutC"):
            texts[s].append(pend[s][1])
            pend[s] = next(it[s], None)
    return {s: "".join(t) for s, t in texts.items()}


def _fasta(path: str, seqs: dict) -> None:
    with open(path, "w") as fh:
        for name, s in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i: i + 60] + "\n")


def write_cgp(dst: str, pkg: str = "augustus_tpu_torch",
              seed: int = CGP_SEED, seqids=None,
              loader: str = "functions") -> dict:
    """Write the cgp input into dst: {"tree", "aln", "tbl", "db", "hints",
    "genomes": {species: path}}; the SQLite store through pkg's
    cgp.sqlite_db functions or its load2sqlitedb command line (loader
    "functions" or "cli", load_store); only the sequences `seqids` when
    given."""
    os.makedirs(dst, exist_ok=True)
    seqs, blocks = genomes(seed, seqids)
    paths = {"genomes": {}}
    with open(os.path.join(dst, "genomes.tbl"), "w") as fh:
        for spec in SPECIES:
            p = os.path.join(dst, f"{spec}.fa")
            _fasta(p, seqs[spec])
            paths["genomes"][spec] = p
            fh.write(f"{spec}\t{spec}.fa\n")
    paths["tbl"] = os.path.join(dst, "genomes.tbl")
    paths["tree"] = os.path.join(dst, "tree.nwk")
    with open(paths["tree"], "w") as fh:
        fh.write(TREE)
    paths["aln"] = os.path.join(dst, "aln.maf")
    with open(paths["aln"], "w") as fh:
        fh.write("##maf version=1 scoring=none\n")
        for seqid, rows in blocks.items():
            fh.write("a score=0\n")
            for spec, start, size, text in rows:
                fh.write(f"s {spec}.{seqid} {start} {size} + "
                         f"{len(seqs[spec][seqid])} {text}\n")
            fh.write("\n")
    paths["hints"] = os.path.join(dst, "hs.hints.gff")
    with open(paths["hints"], "w") as fh:
        for seqid, kind, b, e, strand in HINTS:
            if seqid not in seqs["hs"]:
                continue
            fh.write(f"{seqid}\tb2h\t{kind}\t{b}\t{e}\t0\t{strand}\t.\t"
                     "src=E\n")
    paths["db"] = os.path.join(dst, "cgp.db")
    load_store(paths["db"], paths, pkg, loader)
    return paths


def load_store(db: str, paths: dict, pkg: str = "augustus_tpu_torch",
               loader: str = "functions") -> str:
    """Write the SQLite store db anew from write_cgp's genomes (chunks of
    SQL_CHUNK bases) and hs's hints, through pkg's cgp.sqlite_db
    functions ("functions") or through its command line
    cli/load2sqlitedb.py, main() in this process, once per genome and once
    for the hints ("cli"); the command lines' standard output (empty for
    "functions")."""
    if os.path.exists(db):
        os.remove(db)
    if loader == "functions":
        sq = importlib.import_module(pkg + ".cgp.sqlite_db")
        for spec in SPECIES:
            sq.load2sqlitedb(db, spec, paths["genomes"][spec],
                             chunksize=SQL_CHUNK)
        sq.load_hints2sqlitedb(db, "hs", paths["hints"])
        return ""
    if loader != "cli":
        raise ValueError(f"loader {loader!r}: 'functions' or 'cli'")
    cli = importlib.import_module(pkg + ".cli.load2sqlitedb")
    runs = [[f"--species={spec}", f"--dbaccess={db}",
             f"--chunksize={SQL_CHUNK}", paths["genomes"][spec]]
            for spec in SPECIES]
    runs.append(["--species=hs", f"--dbaccess={db}", paths["hints"]])
    out = io.StringIO()
    for argv in runs:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"load2sqlitedb {argv} exited {rc}")
    return out.getvalue()


def store_tables(db: str) -> dict:
    """{table: (its CREATE statement, its rows with their rowid, in rowid
    order)} of every table of the SQLite file db."""
    con = sqlite3.connect(db)
    try:
        out = {}
        for name, sql in con.execute(
                "SELECT name, sql FROM sqlite_master WHERE type='table' "
                "ORDER BY name").fetchall():
            out[name] = (sql, con.execute(
                f"SELECT rowid, * FROM {name} ORDER BY rowid").fetchall())
        return out
    finally:
        con.close()


def fasta_letters(path: str) -> dict:
    """{name: letters} of a FASTA file, read line by line."""
    out, name = {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                out[name] = []
            elif name is not None:
                out[name].append(line.strip())
    return {k: "".join(v) for k, v in out.items()}


def getseq_text(seq: str, name: str, start: int, end: int,
                rc: bool = False) -> str:
    """getSeq's output for the 1-based inclusive [start, end] of the
    letters seq named name: a header and lines of 60 letters, reverse
    complemented with the case kept (softmasking) when rc."""
    s = seq[start - 1: end]
    if rc:
        s = "".join({"A": "T", "C": "G", "G": "C", "T": "A", "a": "t",
                     "c": "g", "g": "c", "t": "a"}.get(c, c)
                    for c in reversed(s))
    return f">{name} {start}..{end}\n" + "".join(
        s[i: i + 60] + "\n" for i in range(0, len(s), 60))


MYSQL_STUB = '''"""A stand-in for the pymysql module: connect() opens a DB-API double
over an SQLite file named after the database, beside this module.  Its
cursor advertises the qmark paramstyle, records every statement it is
given in LOG[database] as (sql, params), and runs it with MySQL's three
phrases of the load2db schema rewritten for SQLite (AUTO_INCREMENT,
KEY region (...), INSERT IGNORE)."""
import os
import re
import sqlite3

HERE = os.path.dirname(os.path.abspath(__file__))
LOG = {}


def sqlite_dialect(sql):
    sql = sql.replace("AUTO_INCREMENT", "AUTOINCREMENT")
    sql = re.sub(r",\\s*KEY region \\([^)]*\\)", "", sql)
    return sql.replace("INSERT IGNORE", "INSERT OR IGNORE")


class Cursor:
    paramstyle = "qmark"

    def __init__(self, cur, log):
        self._cur, self._log = cur, log

    def execute(self, sql, params=()):
        self._log.append((sql, tuple(params)))
        self._cur.execute(sqlite_dialect(sql), tuple(params))
        return self

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()


class Connection:
    def __init__(self, path, log):
        self._con, self._log = sqlite3.connect(path), log

    def cursor(self):
        return Cursor(self._con.cursor(), self._log)

    def commit(self):
        self._con.commit()

    def close(self):
        self._con.close()


def connect(host, user, password, database, port=3306):
    return Connection(os.path.join(HERE, database + ".sqlite"),
                      LOG.setdefault(database, []))
'''


def write_mysql_stub(dst: str) -> str:
    """Write MYSQL_STUB as dst/pymysql.py; dst."""
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "pymysql.py"), "w") as fh:
        fh.write(MYSQL_STUB)
    return dst


@contextlib.contextmanager
def mysql_stub_on_path(stub_dir: str):
    """The stand-in module of write_mysql_stub importable as `pymysql` in
    this process while the block runs; yields the module."""
    saved = sys.modules.pop("pymysql", None)
    sys.path.insert(0, stub_dir)
    try:
        yield importlib.import_module("pymysql")
    finally:
        sys.path.remove(stub_dir)
        sys.modules.pop("pymysql", None)
        if saved is not None:
            sys.modules["pymysql"] = saved
