"""The genome-store command lines of the port (cli/getSeq, cli/load2sqlitedb,
cli/load2db) against augustus_tpu's on the seeded cgp input
(tests/torch_cgp_fixtures.py: three species of two sequences, chunks of
SQL_CHUNK bases): each case runs both packages' main() in this process
and compares standard output, standard error and exit code byte for
byte (getSeq's usage is its module's docstring, which names its own
package: the port's text is read with its package name as augustus_tpu's),
and the tables each package's run leaves in its store row for row in
rowid order.  load2db runs over the stand-in `pymysql` module of
torch_cgp_fixtures.write_mysql_stub (a recording DB-API double over
SQLite), put first on sys.path for the test only: both packages must give
it the same statements."""

import contextlib
import importlib
import io
import os
import sys

import pytest

import torch_cgp_fixtures as F

PKGS = ("augustus_tpu", "augustus_tpu_torch")
# the first words of getSeq's usage, its module docstring
GETSEQ_USAGE = "Retrieve a (sub)sequence"


@pytest.fixture(scope="module")
def cgp(tmp_path_factory):
    """The seeded cgp input and its store (the port's functions) and the
    letters of every species' sequences."""
    paths = F.write_cgp(str(tmp_path_factory.mktemp("store_cli")))
    seqs, _ = F.genomes()
    return paths, seqs


def _run(pkg, tool, argv):
    """(stdout, stderr, exit code) of pkg's cli.<tool>.main(argv), the
    port's text read with its package name as augustus_tpu's."""
    out, err = io.StringIO(), io.StringIO()
    main = importlib.import_module(f"{pkg}.cli.{tool}").main
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    texts = [out.getvalue(), err.getvalue()]
    if pkg == "augustus_tpu_torch":
        texts = [t.replace("augustus_tpu_torch", "augustus_tpu")
                 for t in texts]
    return texts[0], texts[1], rc


def _both(tool, argv, cwd=None):
    """Both packages' _run, each in its own working directory under cwd
    when given (the stores named relatively, so that the texts that name
    them are alike)."""
    got = []
    for pkg in PKGS:
        if cwd is None:
            got.append(_run(pkg, tool, argv))
            continue
        d = os.path.join(cwd, pkg)
        os.makedirs(d, exist_ok=True)
        here = os.getcwd()
        os.chdir(d)
        try:
            got.append(_run(pkg, tool, argv))
        finally:
            os.chdir(here)
    assert got[0] == got[1]
    return got[0]


def _chunks(seqs: dict, chunk) -> int:
    """The genome chunks of {seqid: letters} at --chunksize=chunk (None:
    the default, 50,000)."""
    return sum(-(-len(s) // (chunk or 50000)) for s in seqs.values())


# ---- load2sqlitedb --------------------------------------------------------

@pytest.mark.parametrize("chunk", [1000, 7, None],
                         ids=["chunk1000", "chunk7", "default"])
def test_load2sqlitedb_equal(cgp, tmp_path, chunk):
    paths, seqs = cgp
    size = [] if chunk is None else [f"--chunksize={chunk}"]
    for spec in F.SPECIES:
        out, err, rc = _both("load2sqlitedb", [
            f"--species={spec}", "--dbaccess=cgp.db", *size,
            paths["genomes"][spec]], cwd=str(tmp_path))
        assert (out, err, rc) == (
            f"loaded {_chunks(seqs[spec], chunk)} genome chunks for {spec} "
            "into cgp.db\n", "", 0)
    out, err, rc = _both("load2sqlitedb", [
        "--species=hs", "--dbaccess=cgp.db", paths["hints"]],
        cwd=str(tmp_path))
    assert (out, err, rc) == (
        f"loaded {len(F.HINTS)} hints for hs into cgp.db\n", "", 0)
    a, b = (F.store_tables(str(tmp_path / p / "cgp.db")) for p in PKGS)
    assert a == b
    assert len(a["genomes"][1]) == sum(_chunks(g, chunk)
                                       for g in seqs.values())
    assert len(a["hints"][1]) == len(F.HINTS)
    if chunk == F.SQL_CHUNK:
        # the store write_cgp builds through the functions
        assert a == F.store_tables(paths["db"])


@pytest.mark.parametrize("argv", [
    [], ["--species=hs", "x.fa"], ["--dbaccess=x.db", "x.fa"],
    ["--species=hs", "--dbaccess=x.db"]],
    ids=["nothing", "no_db", "no_species", "no_input"])
def test_load2sqlitedb_usage(tmp_path, argv):
    out, err, rc = _both("load2sqlitedb", argv, cwd=str(tmp_path))
    assert (out, rc) == ("", 1) and err.startswith("usage: load2sqlitedb")


def test_load2sqlitedb_hints_of_an_unknown_species(cgp, tmp_path):
    paths, _ = cgp
    raised = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        importlib.import_module(f"{pkg}.cli.load2sqlitedb").main([
            "--species=hs", f"--dbaccess={d / 'cgp.db'}",
            paths["genomes"]["hs"]])
        with pytest.raises(KeyError) as e, \
                contextlib.redirect_stdout(io.StringIO()):
            importlib.import_module(f"{pkg}.cli.load2sqlitedb").main([
                "--species=mutB", f"--dbaccess={d / 'cgp.db'}",
                paths["hints"]])
        raised.append(str(e.value))
    assert raised[0] == raised[1] == "'species mutB not in database'"


# ---- getSeq ---------------------------------------------------------------

# (id, arguments after the store's, (1-based start, end or None for the
# whole sequence, reverse complement) of the expected slice)
GETSEQ = [
    ("whole", [], (1, None, False)),
    ("chunk_crossing", ["--start=941", "--end=1070"], (941, 1070, False)),
    ("first_base", ["--start=1", "--end=1"], (1, 1, False)),
    ("rc", ["--start=941", "--end=1070", "--rc"], (941, 1070, True)),
    ("rc_whole", ["--rc"], (1, None, True)),
]


@pytest.mark.parametrize("mode", ["sqlite", "sqlite_tbl", "mem"])
@pytest.mark.parametrize("case", GETSEQ, ids=[c[0] for c in GETSEQ])
def test_getseq_equal(cgp, mode, case):
    paths, seqs = cgp
    store = {"sqlite": [f"--dbaccess={paths['db']}"],
             "sqlite_tbl": [f"--dbaccess={paths['db']}",
                            f"--speciesfilenames={paths['tbl']}"],
             "mem": [f"--speciesfilenames={paths['tbl']}"]}[mode]
    _, extra, (start, end, rc) = case
    for spec in F.SPECIES:
        for name, seq in seqs[spec].items():
            out, err, code = _both("getSeq", [
                f"--species={spec}", f"--seq={name}", *store, *extra])
            assert (err, code) == ("", 0)
            assert out == F.getseq_text(seq, name, start, end or len(seq),
                                        rc)


# (id, arguments (STORE and TBL: the store's and the table's), exit code,
# standard error, or its first words for the usage)
GETSEQ_EXITS = [
    ("no_species", ["--seq=HS04636", "--speciesfilenames=x"], 1,
     GETSEQ_USAGE),
    ("no_seq", ["--species=hs", "--dbaccess=x.db"], 1, GETSEQ_USAGE),
    ("no_store", ["--species=hs", "--seq=HS04636"], 1,
     "one of --dbaccess / --speciesfilenames needed\n"),
    ("unknown_seq_sqlite", ["--species=hs", "--seq=chrX", "--end=10",
                            "STORE"], 1, "sequence chrX not found for hs\n"),
    ("unknown_seq_mem", ["--species=hs", "--seq=chrX", "--end=10", "TBL"],
     1, "sequence chrX not found for hs\n"),
    ("help", ["--help"], 0, GETSEQ_USAGE),
    ("h", ["-h"], 0, GETSEQ_USAGE),
]


@pytest.mark.parametrize("case", GETSEQ_EXITS,
                         ids=[c[0] for c in GETSEQ_EXITS])
def test_getseq_exits(cgp, case):
    paths, _ = cgp
    _, argv, want_rc, want_err = case
    argv = [{"STORE": f"--dbaccess={paths['db']}",
             "TBL": f"--speciesfilenames={paths['tbl']}"}.get(a, a)
            for a in argv]
    out, err, rc = _both("getSeq", argv)
    assert (out, rc) == ("", want_rc)
    if want_err == GETSEQ_USAGE:
        assert err.startswith(GETSEQ_USAGE)
    else:
        assert err == want_err


# ---- load2db --------------------------------------------------------------

@pytest.fixture
def stub(tmp_path):
    """The stand-in pymysql module, importable while the test runs."""
    with F.mysql_stub_on_path(F.write_mysql_stub(str(tmp_path / "stub"))) \
            as mod:
        yield mod


@pytest.mark.parametrize("chunk", [1000, None], ids=["chunk1000", "default"])
def test_load2db_equal(cgp, stub, chunk):
    paths, seqs = cgp
    size = [] if chunk is None else [f"--chunksize={chunk}"]
    runs = [[f"--species={spec}", *size, paths["genomes"][spec]]
            for spec in F.SPECIES] + [["--species=hs", paths["hints"]]]
    for argv in runs:
        got = [_run(pkg, "load2db", [
            f"--dbaccess={pkg},localhost,user,secret,3306", *argv])
            for pkg in PKGS]
        assert got[0] == got[1]
        assert got[0][1:] == ("", 0) and got[0][0].startswith("loaded ")
    assert stub.LOG["augustus_tpu"] == stub.LOG["augustus_tpu_torch"]
    assert any(sql.startswith("INSERT IGNORE INTO featuretypes")
               for sql, _ in stub.LOG["augustus_tpu"])
    a, b = (F.store_tables(os.path.join(os.path.dirname(stub.__file__),
                                        f"{pkg}.sqlite")) for pkg in PKGS)
    assert a == b
    assert len(a["genomes"][1]) == sum(_chunks(g, chunk)
                                       for g in seqs.values())
    assert len(a["hints"][1]) == len(F.HINTS)
    assert len(a["featuretypes"][1]) == 17


def test_load2db_usage():
    out, err, rc = _both("load2db", ["--species=hs", "x.fa"])
    assert (out, rc) == ("", 1) and err.startswith("usage: load2db")


def test_load2db_without_a_mysql_module(cgp, monkeypatch):
    paths, _ = cgp
    for name in ("pymysql", "MySQLdb", "mysql", "mysql.connector"):
        monkeypatch.setitem(sys.modules, name, None)
    raised = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            _run(pkg, "load2db", ["--species=hs",
                                  "--dbaccess=db,localhost,user,secret",
                                  paths["genomes"]["hs"]])
        raised.append((type(e.value).__name__, str(e.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] == "RuntimeError"
    assert raised[0][1].startswith("No MySQL driver installed")
