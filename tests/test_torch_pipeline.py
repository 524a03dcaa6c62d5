"""The port's pipeline tools (augustus_tpu_torch/pipeline/{chunking,
convert, hints_gen, trainprep, transmap2hints, optimize}.py) against
augustus_tpu's on the same inputs: a counterpart of each case of
tests/test_pipeline.py, the cases that read the reference tree on repo
inputs instead, and the same tools on the seeded BAM's hints and wiggle
track (tests/torch_pipeline_fixtures.py).  Texts byte-equal."""

import importlib
import io
import os
import textwrap

import pytest

import torch_pipeline as TP
import torch_pipeline_fixtures as F

DATA = TP.DATA
PKGS = ("augustus_tpu", "augustus_tpu_torch")


def both(name: str, fn: str, *args, **kw):
    """fn of pkg.pipeline.<name> on the same arguments, for each package."""
    return [getattr(importlib.import_module(f"{p}.pipeline.{name}"), fn)(
        *args, **kw) for p in PKGS]


JOIN_CHUNKS = [textwrap.dedent("""\
    # start gene g1
    chr1\tAUGUSTUS\tgene\t100\t200\t1\t+\t.\tg1
    chr1\tAUGUSTUS\tCDS\t100\t200\t.\t+\t0\ttranscript_id "g1.t1"; gene_id "g1";
    # end gene g1
    # start gene g2
    chr1\tAUGUSTUS\tgene\t900\t990\t1\t+\t.\tg2
    chr1\tAUGUSTUS\tCDS\t900\t990\t.\t+\t0\ttranscript_id "g2.t1"; gene_id "g2";
    # end gene g2
    """), textwrap.dedent("""\
    # start gene g1
    chr1\tAUGUSTUS\tgene\t900\t990\t1\t+\t.\tg1
    chr1\tAUGUSTUS\tCDS\t900\t990\t.\t+\t0\ttranscript_id "g1.t1"; gene_id "g1";
    # end gene g1
    # start gene g2
    chr1\tAUGUSTUS\tgene\t1500\t1600\t1\t+\t.\tg2
    chr1\tAUGUSTUS\tCDS\t1500\t1600\t.\t+\t0\ttranscript_id "g2.t1"; gene_id "g2";
    # end gene g2
    """)]


def test_join_aug_pred_dedups_overlap_genes():
    got, want = both("chunking", "join_aug_pred", JOIN_CHUNKS)
    assert got == want
    genes = [l for l in got.splitlines() if "\tgene\t" in l]
    assert [g.split("\t")[8] for g in genes] == ["g1", "g2", "g3"]
    assert 'gene_id "g3"' in got


def test_split_and_joblist(tmp_path):
    fa = tmp_path / "g.fa"
    fa.write_text(">a\n" + "acgt" * 300 + "\n>b\n" + "ttaa" * 200 + "\n")
    files = []
    for pkg in PKGS:
        ch = importlib.import_module(f"{pkg}.pipeline.chunking")
        out = tmp_path / pkg
        paths = ch.split_mfasta(str(fa), str(out), min_size=1000)
        files.append([os.path.basename(p) for p in paths] +
                     [open(p).read() for p in paths])
    assert files[0] == files[1] and len(files[0]) == 4
    got, want = both("chunking", "make_joblist", str(fa), chunk_size=500,
                     overlap=100)
    assert got == want
    assert got[0] == ("a", 1, 500) and got[1] == ("a", 401, 900)


def test_chunk_jobs_of_the_chunks_phase(tmp_path):
    """The jobs of chip_smoke.py's chunks phase: at least three per
    sequence, equal in both packages."""
    got = TP.chunk_jobs(TP.PORT, str(tmp_path / "p"))
    want = TP.chunk_jobs("augustus_tpu", str(tmp_path / "j"))
    assert [j[1:] for j in got] == [j[1:] for j in want]
    per_seq = {}
    for _, name, _, _ in got:
        per_seq[name] = per_seq.get(name, 0) + 1
    assert per_seq == {"HS04636": 14, "HS08198": 3}


def test_chunks_predicted_and_joined(tmp_path):
    """HS08198.fa cut into its three overlapping jobs, each predicted with
    --predictionStart/--predictionEnd (the port on the CPU), the outputs
    merged by join_aug_pred: equal to augustus_tpu's."""
    texts = []
    for pkg in PKGS:
        ch = importlib.import_module(f"{pkg}.pipeline.chunking")
        path = os.path.join(DATA, "HS08198.fa")
        outs = [TP.predict(pkg, TP.chunk_args(s, e), path, "cpu")
                for _, s, e in ch.make_joblist(path, TP.CHUNK_SIZE,
                                               TP.CHUNK_OVERLAP)]
        texts.append(ch.join_aug_pred(outs))
    assert texts[0] == texts[1]
    assert texts[0].count("\tgene\t") >= 2


def _psl_line():
    return ("100\t0\t0\t0\t0\t0\t0\t1000\t+\tq1\t100\t0\t100\t"
            "chr1\t50000\t1000\t2200\t2\t50,50,\t0,50,\t1000,2150,")


def test_psl_to_hints():
    got, want = both("hints_gen", "psl_to_hints", [_psl_line()])
    assert got == want
    types = [h.split("\t")[2] for h in got]
    assert types.count("ep") == 2 and types.count("intron") == 1


def test_psl_to_hints_of_the_bam():
    """The seeded BAM's alignments as PSL lines, through blat2hints'
    rules."""
    lines = sorted(F.psl_lines(), key=lambda l: l.split("\t")[9])
    got, want = both("hints_gen", "psl_to_hints", lines)
    assert got == want and any("\tintron\t" in h for h in got)


def test_join_mult_hints():
    lines = [
        "chr1\tb2h\tintron\t100\t200\t0\t+\t.\tsrc=E;grp=a",
        "chr1\tb2h\tintron\t100\t200\t0\t+\t.\tsrc=E;grp=b",
        "chr1\tb2h\tintron\t300\t400\t0\t+\t.\tsrc=E",
    ]
    got, want = both("hints_gen", "join_mult_hints", lines)
    assert got == want and len(got) == 2
    assert got[0].split("\t")[8].startswith("mult=2")


@pytest.fixture(scope="module")
def bam_hints(tmp_path_factory):
    """(BAM path, its wiggle text, its --exonhints hint lines)."""
    from augustus_tpu_torch.pipeline.bam2hints import Bam2Hints
    from augustus_tpu_torch.pipeline.wig import bam_to_wig
    bam = F.write_bam(str(tmp_path_factory.mktemp("bam") / "reads.bam"))
    wig, hints = io.StringIO(), io.StringIO()
    bam_to_wig(bam, wig, trackname="rna")
    Bam2Hints(introns_only=False, ss_on=True).run(bam, hints)
    return bam, wig.getvalue(), hints.getvalue().splitlines()


@pytest.mark.parametrize("kw", [
    {}, {"width": 20, "margin": 10, "minscore": 2.0, "minthresh": 1.0,
         "typ": "exonpart", "src": "W", "pri": 4},
    {"radius": 5.0, "prune": 0.5, "strand": "+"}])
def test_wig_to_hints(bam_hints, kw):
    got, want = both("hints_gen", "wig_to_hints",
                     bam_hints[1].splitlines(True), **kw)
    assert got == want and got


@pytest.mark.parametrize("pattern", ["GTAG", "GCAG", "ATAC"])
def test_filter_splice_hints(bam_hints, pattern):
    introns = [l for l in bam_hints[2] if "\tintron\t" in l]
    got, want = both("hints_gen", "filter_splice_hints",
                     os.path.join(DATA, "HS04636.fa"), introns, pattern)
    assert got == want
    if pattern == "GTAG":
        assert got


def test_gff2gb_roundtrip(tmp_path):
    """gff2gbSmallDNA output readable by the port's GenBank reader, equal
    to augustus_tpu's; random_split of it."""
    from augustus_tpu_torch.io.genbank import read_genbank
    fa = tmp_path / "g.fa"
    seq = "".join("acgt"[(i * 7) % 4] for i in range(2000))
    seq = seq[:500] + "atg" + seq[503:900] + "taa" + seq[903:]
    fa.write_text(">chr1\n" + seq + "\n")
    gff = tmp_path / "a.gff"
    gff.write_text(
        'chr1\ttest\tCDS\t501\t600\t.\t+\t0\ttranscript_id "t1";\n'
        'chr1\ttest\tCDS\t801\t903\t.\t+\t1\ttranscript_id "t1";\n')
    texts = [both("trainprep", "gff2gb", str(gff), str(fa), flank=100)]
    assert texts[0][0] == texts[0][1]
    out = tmp_path / "out.gb"
    out.write_text(texts[0][0])
    annos = read_genbank(str(out))
    assert len(annos) == 1 and annos[0].genes[0].exons == \
        [(100, 199), (400, 502)]
    splits = []
    for pkg in PKGS:
        gb = tmp_path / f"{pkg}.gb"
        gb.write_text(texts[0][0] * 3)
        ts = importlib.import_module(f"{pkg}.pipeline.trainprep")
        tr, te = ts.random_split(str(gb), 1)
        splits.append((open(tr).read(), open(te).read()))
    assert splits[0] == splits[1] and splits[0][1].count("//") == 1


def test_small_gb_cut_by_gff2gb(tmp_path):
    """The two records test_torch_optimize.py trains on, cut by each
    package's gff2gb: equal, at most 6 kb each."""
    from augustus_tpu.pipeline.trainprep import gff2gb as jg
    from augustus_tpu_torch.io.genbank import read_genbank
    from augustus_tpu_torch.pipeline.trainprep import gff2gb as pg
    got = F.write_small_gb(str(tmp_path / "p"), pg)
    want = F.write_small_gb(str(tmp_path / "j"), jg)
    assert open(got).read() == open(want).read()
    annos = read_genbank(got)
    assert len(annos) == 2
    assert all(a.length <= 6000 and len(a.genes) == 1 for a in annos)


def test_gtf2gff3():
    lines = [
        "chr1\tA\tgene\t1\t10\t.\t+\t.\tg1",
        "chr1\tA\ttranscript\t1\t10\t.\t+\t.\tg1.t1",
        'chr1\tA\tCDS\t1\t10\t.\t+\t0\ttranscript_id "g1.t1"; '
        'gene_id "g1";',
    ]
    got, want = both("convert", "gtf_to_gff3", lines)
    assert got == want
    assert got[0] == "chr1\tA\tgene\t1\t10\t.\t+\t.\tID=g1;"


def test_gtf2gff3_of_a_prediction():
    with open(os.path.join(TP.GOLDEN_DIR, "repo_fixture_HS04636.gff")) as fh:
        lines = fh.read().splitlines(True)
    got, want = both("convert", "gtf_to_gff3", lines)
    assert got == want and any("Parent=g2.t1;" in l for l in got)


@pytest.mark.parametrize("kind", ["protein", "coding"])
def test_get_anno_fasta(kind):
    with open(os.path.join(TP.GOLDEN_DIR, "repo_fixture_HS04636.gff")) as fh:
        lines = fh.read().splitlines(True)
    got, want = both("convert", "get_anno_fasta", lines, kind=kind)
    assert got == want
    if kind == "protein":
        assert got[0] == ">g1.t1"


def test_metapars_parsing(tmp_path):
    """parse_metapars on a generated file with the three kinds of
    candidate lists (explicit, integer range, float range)."""
    path = tmp_path / "sp_metapars.cfg"
    path.write_text(
        '# comment\n'
        '/Constant/dss_end   "1"-"4"\n'
        '/IntronModel/k      "3" "4" "5"\n'
        '/ExonModel/patpseudocount "0.5"_"5"\n'
        '/Constant/ass_start   "1"-"20"\n'
        '\n/broken\n')
    got, want = both("optimize", "parse_metapars", str(path))
    assert got == want
    d = dict(got)
    assert d["/Constant/dss_end"] == ["1", "2", "3", "4"]
    assert d["/IntronModel/k"] == ["3", "4", "5"]
    assert len(d["/ExonModel/patpseudocount"]) == 6
    assert "/broken" not in d


@pytest.mark.parametrize("name", ["repo_fixture_eval_crf3.out",
                                  "repo_fixture_eval_test1.out",
                                  "repo_fixture_utr_eval_utrtrain.out"])
def test_accuracy_target(name):
    with open(os.path.join(TP.GOLDEN_DIR, name)) as fh:
        text = fh.read()
    got, want = both("optimize", "accuracy_target", text)
    assert got == want


def test_split_buckets(tmp_path):
    buckets = []
    for pkg in PKGS:
        opt = importlib.import_module(f"{pkg}.pipeline.optimize")
        d = tmp_path / pkg
        d.mkdir()
        paths = opt.split_buckets(os.path.join(DATA, "genes_crf3.gb"), 2,
                                  str(d))
        buckets.append([open(p).read() for p in paths])
    assert buckets[0] == buckets[1]
    assert [b.count("LOCUS") for b in buckets[0]] == [2, 1]


def test_exonerate2hints():
    lines = [
        "chr1\texonerate:protein2genome:local\tgene\t100\t900\t800\t+\t."
        "\tgene_id 1 ; sequence protX ; gene_orientation +\n",
        "chr1\texonerate:protein2genome:local\tcds\t100\t400\t.\t+\t.\t\n",
        "chr1\texonerate:protein2genome:local\tintron\t401\t700\t.\t+\t.\t\n",
        "chr1\texonerate:protein2genome:local\tintron\t701\t720\t.\t+\t.\t\n",
        "chr1\texonerate:protein2genome:local\tcds\t880\t890\t.\t+\t.\t\n",
    ]
    got, want = both("hints_gen", "exonerate_to_hints", lines)
    assert got == want
    assert got[0] == ("chr1\txnt2h\tCDSpart\t115\t385\t.\t+\t.\t"
                      "src=XNT;grp=protX;pri=4")


POLYA_ROWS = {
    "new": ["est1", "chr2", "+"] + ["x"] * 6 + ["1234"] + ["x", "x"],
    "newer": ["est2", "x", "chr3", "-"] + ["x"] * 6 + ["777"] + ["x", "x"]}


@pytest.mark.parametrize("kw", [{"fmt": "new"},
                                {"fmt": "new", "swapstrand": True},
                                {"fmt": "newer", "hintradius": 3}])
def test_polya2hints(kw):
    rows = ["\t".join(POLYA_ROWS[kw["fmt"]]), "too\tshort"]
    got, want = both("hints_gen", "polya_to_hints", rows, **kw)
    assert got == want and len(got) == 1


def test_gb2gff_and_summarize():
    """gb_to_gff of tests/data/genes_crf3.gb and summarize_acgt of
    HS04636.fa (the reference's examples are not in the repo)."""
    got, want = both("convert", "gb_to_gff",
                     os.path.join(DATA, "genes_crf3.gb"))
    assert got == want
    assert sum("\tgene\t" in l for l in got) == 3
    assert all('transcript_id "' in l for l in got if "\tCDS\t" in l)
    for fa in ("HS04636.fa", "HS08198.fa"):
        got, want = both("convert", "summarize_acgt",
                         os.path.join(DATA, fa))
        assert got == want
        assert got[-3].startswith("summary: BASE COUNT")


def test_filter_genes(tmp_path):
    gb = ("LOCUS AAA 10 bp\nORIGIN\n  1 acgtacgtac\n//\n"
          "LOCUS BBB 10 bp\nORIGIN\n  1 acgtacgtac\n//\n")
    db = tmp_path / "db.gb"
    db.write_text(gb)
    names = tmp_path / "bad.lst"
    names.write_text("AAA\n")
    got, want = both("trainprep", "filter_genes", str(names), str(db))
    assert got == want
    assert "LOCUS BBB" in got and "LOCUS AAA" not in got


TRANSMAP = [
    "mrna1-1\tchr1\t+\t1000\t5000\t1500\t4500\t3\t1000,2500,4000,\t"
    "2000,3000,5000,\t0\tx\tcmpl\tcmpl\t0,1,2\t1,1,\n",
    "mrna2-1\tchr1\t-\t8000\t12000\t8500\t11000\t2\t8000,10000,\t"
    "9000,12000,\t0\ty\tincmpl\tcmpl\t0,2\t1,1,\n",
    "mrna3-1\tchr2\t+\t100\t700\t100\t700\t1\t100,\t700,\t0\tz\tcmpl\t"
    "incmpl\t0\t1,\n"]


def test_transmap2hints():
    outs = []
    for pkg in PKGS:
        tm = importlib.import_module(f"{pkg}.pipeline.transmap2hints")
        out = io.StringIO()
        tm.TransMap2Hints(out).run(io.StringIO("".join(TRANSMAP)))
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert ("chr1\tt2h\ttss\t901\t1101\t0\t+\t0\t"
            "grp=mrna1-1;src=T;pri=4") in outs[0].splitlines()
