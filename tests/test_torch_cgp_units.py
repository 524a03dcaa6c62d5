"""The port's cgp modules unit by unit on the CPU, against augustus_tpu's:
the counterparts of tests/test_codonevo.py and tests/test_logreg.py, run
on both packages with equal results; the MySQL store's MysqlAccess of
both packages over one open sqlite3 connection whose cursors advertise
paramstyle "qmark" (the test double that augustus_tpu/cgp/mysql_db.py:
_exec accepts), with the behaviours the port keeps as they are: hints
selected by containment in the window, not by overlap."""

import importlib
import sqlite3

import numpy as np
import pytest

PKGS = ("augustus_tpu", "augustus_tpu_torch")


def _mods(name):
    return [importlib.import_module(f"{p}.cgp.{name}") for p in PKGS]


def test_omega_grid_matches_reference_examples():
    for ce in _mods("codonevo"):
        assert np.allclose(ce.omega_grid(5), [0.5, 0.75, 1, 4 / 3.0, 2])
        g10 = ce.omega_grid(10)
        assert np.allclose(
            np.round(g10, 2), [0.29, 0.43, 0.57, 0.71, 0.86, 1, 1.17,
                               1.4, 1.75, 2.33], atol=0.005)
        assert ce.omega_grid(2).tolist() == [1 - 1 / 3.0, 1.0]
    a, b = _mods("codonevo")
    for k in (2, 5, 10, 20):
        assert np.array_equal(a.omega_grid(k), b.omega_grid(k))
        assert np.array_equal(a.omega_prior(a.omega_grid(k)),
                              b.omega_prior(b.omega_grid(k)))


def test_rate_matrix_properties():
    outs = []
    for ce in _mods("codonevo"):
        pi = ce.estimate_pi(["atggctgctaaagctgcttggtctcat" * 4])
        Q = ce.codon_rate_matrix(pi, 0.7, 4.0)
        assert np.abs(Q.sum(axis=1)).max() < 1e-12
        assert abs(-(np.diag(Q) * pi).sum() - 1.0) < 1e-12
        taa = 3 * 16 + 0 * 4 + 0
        assert np.abs(Q[taa]).max() == 0.0
        bal = pi[:, None] * Q - (pi[:, None] * Q).T
        assert np.abs(bal).max() < 1e-12
        outs.append((pi, Q))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_probability_matrices_and_omega_estimation():
    res = []
    for ce, ph in zip(_mods("codonevo"), _mods("phylo")):
        pi = ce.estimate_pi(["atggctgctaaagctgcttggtctcatccc" * 5])
        tree = ph.PhyloTree(ph.parse_newick("((a:0.1,b:0.1):0.05,c:0.2);"))
        evo = ce.CodonEvo(pi, [0.1, 0.1, 0.05, 0.2], k=8, m=10)
        pos = pi > 0
        for v in (0, evo.times.shape[0] - 1):
            P = evo.P[0, v]
            assert np.abs(P[pos].sum(axis=1) - 1).max() < 1e-9
        tup = np.full((8, 3), 10, dtype=np.int64)
        w, subst, post = evo.est_omega(tree, tup)
        assert subst == 0 and w <= 1.0 and post < 1.0
        rng = np.random.RandomState(1)
        tup2 = rng.randint(0, 64, (12, 3))
        w2, s2, p2 = evo.est_omega(tree, tup2)
        assert s2 > 10
        res.append((evo.P, w, subst, post, w2, s2, p2))
    assert np.array_equal(res[0][0], res[1][0])
    assert res[0][1:] == res[1][1:]


def test_fitch_counts():
    for ce, ph in zip(_mods("codonevo"), _mods("phylo")):
        tree = ph.PhyloTree(ph.parse_newick("((a:1,b:1):1,c:1);"))
        assert ce.fitch_substitutions(
            tree, np.array([[5, 5, 9], [7, 7, 7]])) == 1
        assert ce.fitch_substitutions(tree, np.array([[5, 64, 9]])) == 1


def _synthetic(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    w_true = np.array([0.5, 2.0, -1.5, 0.7])
    z = w_true[0] + X @ w_true[1:]
    y = (1 / (1 + np.exp(-z)) > rng.rand(n)).astype(int)
    return [(int(yi), [1.0] + list(xi)) for yi, xi in zip(y, X)]


def test_logreg_train_separates_classes():
    models = []
    for lr in _mods("train_logreg"):
        samples = _synthetic()
        model = lr.train(samples)
        p = lr.predict_proba(np.array([s[1] for s in samples]), model)
        y = np.array([s[0] for s in samples])
        assert ((p > 0.5) == y).mean() > 0.75
        zero = {"weights": np.zeros(4), "mean": model["mean"],
                "se": model["se"]}
        assert lr.cross_entropy(samples, model) < \
            lr.cross_entropy(samples, zero)
        models.append(model)
    for k in ("weights", "mean", "se"):
        assert np.array_equal(models[0][k], models[1][k])


def test_logreg_cfg_roundtrip(tmp_path):
    texts = []
    for i, lr in enumerate(_mods("train_logreg")):
        model = lr.train(_synthetic(100))
        path = tmp_path / f"params{i}.cfg"
        lr.write_cfg(str(path), exon_model=model, intron_model=model)
        back = lr.read_cfg(str(path))
        assert np.allclose([back["exon"][k] for k in sorted(back["exon"])],
                           model["weights"], atol=1e-7)
        assert back["intron"] == back["exon"]
        texts.append(path.read_text())
    assert texts[0] == texts[1]


class _Cursor:
    """A sqlite3 cursor that advertises the qmark paramstyle."""
    paramstyle = "qmark"

    def __init__(self, cur):
        self._cur = cur

    def execute(self, sql, params=()):
        return self._cur.execute(sql, params)

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()


class _Connection:
    def __init__(self, con):
        self._con = con

    def cursor(self):
        return _Cursor(self._con.cursor())

    def commit(self):
        self._con.commit()


@pytest.fixture
def mysql_con():
    """The MySQL store's tables (augustus_tpu/cgp/mysql_db.py _SCHEMA, in
    SQLite's dialect) with two species, chunks of 7 bases and hints of
    the featuretypes enum."""
    con = sqlite3.connect(":memory:")
    con.executescript("""
        CREATE TABLE speciesnames (speciesid INTEGER PRIMARY KEY,
                                   speciesname TEXT UNIQUE);
        CREATE TABLE seqnames (seqnr INTEGER PRIMARY KEY, speciesid INTEGER,
                               seqname TEXT);
        CREATE TABLE genomes (seqid INTEGER PRIMARY KEY, dnaseq TEXT,
                              seqnr INTEGER, start INTEGER, end INTEGER,
                              speciesid INTEGER);
        CREATE TABLE hints (hintid INTEGER PRIMARY KEY, speciesid INTEGER,
                            seqnr INTEGER, source TEXT, start INTEGER,
                            end INTEGER, score REAL, type INTEGER,
                            strand TEXT, frame TEXT, priority INTEGER,
                            grp TEXT, mult INTEGER, esource TEXT);
    """)
    seqs = {("hs", "chr1"): "ACGTacgtAAACCCGGGTTTacgtACGTA",
            ("hs", "chr2"): "GGGGCCCCAAAATTTT",
            ("mm", "chrA"): "TTTTGGGGCCCCAAAAacgt"}
    for (spec, name), s in seqs.items():
        con.execute("INSERT OR IGNORE INTO speciesnames (speciesname) "
                    "VALUES (?)", (spec,))
        spid = con.execute("SELECT speciesid FROM speciesnames WHERE "
                           "speciesname=?", (spec,)).fetchone()[0]
        con.execute("INSERT INTO seqnames (speciesid, seqname) VALUES "
                    "(?, ?)", (spid, name))
        nr = con.execute("SELECT seqnr FROM seqnames WHERE seqname=?",
                         (name,)).fetchone()[0]
        for off in range(0, len(s), 7):
            chunk = s[off: off + 7]
            con.execute("INSERT INTO genomes (dnaseq, seqnr, start, end, "
                        "speciesid) VALUES (?,?,?,?,?)",
                        (chunk, nr, off, off + len(chunk) - 1, spid))
    for start, end, typ in ((2, 9, 6), (5, 30, 9), (12, 14, 0)):
        con.execute("INSERT INTO hints (speciesid, seqnr, source, start, "
                    "end, score, type, strand, frame, priority, grp, mult,"
                    " esource) VALUES (1, 1, 'b2h', ?, ?, 0.0, ?, '+', '.',"
                    " 4, 'g1', 1, 'E')", (start, end, typ))
    con.commit()
    yield _Connection(con)
    con.close()


def test_mysql_access_of_both_packages_equal(mysql_con):
    a, b = (m.MysqlAccess(connection=mysql_con) for m in _mods("mysql_db"))
    assert a.species() == b.species() == ["hs", "mm"]
    for spec, name in (("hs", "chr1"), ("hs", "chr2"), ("mm", "chrA")):
        n = a.seq_len(spec, name)
        assert n == b.seq_len(spec, name) > 0
        for lo, hi in ((0, n - 1), (3, 11), (6, 7), (n - 2, n - 1)):
            assert a.get_seq(spec, name, lo, hi) == \
                b.get_seq(spec, name, lo, hi)
        assert len(a.get_seq(spec, name, 0, n - 1)) == n
    assert a.get_seq("hs", "chr1", 0, 28) == "ACGTacgtAAACCCGGGTTTacgtACGTA"
    with pytest.raises(KeyError):
        b.seq_len("hs", "chrX")
    # hints contained in [0, 20]: the exonpart and the start; the intron
    # that only overlaps the window is not returned (containment, as
    # augustus_tpu selects them)
    ha, hb = a.get_hints("hs", "chr1", 0, 20), b.get_hints("hs", "chr1",
                                                            0, 20)
    assert ha == hb
    assert [h["type"] for h in hb] == ["exonpart", "start"]
