"""The port's BAM reader, bam2hints and wiggle tools
(augustus_tpu_torch/pipeline/{bam, bam2hints, wig}.py,
cli/bam2hints.py) against augustus_tpu's on the same seeded BAM
(tests/torch_pipeline_fixtures.py: spliced RNA-seq reads along the genes of
repo_fixture's HS04636.fa golden, noise reads, clipped, inserted, deleted,
'='/'X' and dropped alignments over two references): records equal, texts
byte-equal."""

import io

import pytest

import torch_pipeline as TP
import torch_pipeline_fixtures as F
from augustus_tpu.pipeline import bam as jbam
from augustus_tpu.pipeline import bam2hints as jb2h
from augustus_tpu.pipeline import hints_gen as jhg
from augustus_tpu.pipeline import wig as jwig
from augustus_tpu_torch.pipeline import bam as pbam
from augustus_tpu_torch.pipeline import bam2hints as pb2h
from augustus_tpu_torch.pipeline import hints_gen as phg
from augustus_tpu_torch.pipeline import wig as pwig


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    return F.write_bam(str(tmp_path_factory.mktemp("bam") / "reads.bam"))


def _records(reader_cls, path):
    r = reader_cls(path)
    try:
        return (r.header_text, r.ref_names, r.ref_lengths,
                [tuple(a) for a in r])
    finally:
        r.close()


def test_bam_reader_records_equal(bam):
    got = _records(pbam.BamReader, bam)
    assert got == _records(jbam.BamReader, bam)
    header, names, lengths, als = got
    assert names == ["HS04636", "HS08198"] and lengths == [9453, 2344]
    assert header.startswith("@HD\tVN:1.6")
    # every record the generator wrote, in its order
    want = F.bam_alignments()[2]
    assert [(a[2], a[3], a[0], a[1], [tuple(c) for c in a[5]])
            for a in als] == [(ref, pos, name, flag, cigar)
                              for ref, pos, name, flag, cigar in want]
    ops = {op for a in als for _, op in a[5]}
    assert {"M", "N", "S", "H", "I", "D", "=", "X"} <= ops


def test_bam_reader_refuses_other_files(tmp_path):
    path = tmp_path / "not.bam"
    import gzip
    with gzip.open(path, "wb") as fh:
        fh.write(b"SAM\x01")
    with pytest.raises(ValueError, match="not a BAM file"):
        pbam.BamReader(str(path))


@pytest.mark.parametrize("kw", [
    {}, {"introns_only": False}, {"introns_only": False, "ss_on": True},
    {"mult": False}, {"introns_only": False, "ep_cutoff": 5,
                      "min_endblock_len": 20, "priority": 2, "source": "W"},
    {"maxgaplen": 25, "minintronlen": 40, "maxqgaplen": 0},
    {"max_gene_len": 2000, "introns_only": False}])
def test_bam2hints_equal(bam, kw):
    got, want = io.StringIO(), io.StringIO()
    pb2h.Bam2Hints(**kw).run(bam, got)
    jb2h.Bam2Hints(**kw).run(bam, want)
    assert got.getvalue() == want.getvalue()
    assert "\tintron\t" in got.getvalue()
    if kw.get("introns_only") is False:
        assert "\texonpart\t" in got.getvalue()
    if kw.get("ss_on"):
        assert "\tDSS\t" in got.getvalue() and "\tASS\t" in got.getvalue()


def test_bam2hints_needs_gap_below_intron():
    with pytest.raises(ValueError):
        pb2h.Bam2Hints(maxgaplen=40, minintronlen=32)


@pytest.mark.parametrize("flags", [[], ["--exonhints", "--ssOn"],
                                   ["--nomult", "--priority=3",
                                    "--source=P"]])
def test_bam2hints_cli_equal(bam, tmp_path, flags):
    from augustus_tpu.cli.bam2hints import main as jmain
    from augustus_tpu_torch.cli.bam2hints import main as pmain
    got, want = tmp_path / "got.gff", tmp_path / "want.gff"
    assert pmain([f"--in={bam}", f"--out={got}"] + flags) == 0
    assert jmain([f"--in={bam}", f"--out={want}"] + flags) == 0
    assert got.read_text() == want.read_text() and got.read_text()


@pytest.mark.parametrize("mode", list(TP.HINT_MODES))
def test_joined_hints_equal_and_golden(bam, mode):
    """bam2hints, sorted, join_mult_hints: both packages and the golden of
    chip_smoke.py's pipeline_hints phase."""
    got = TP.hint_texts(TP.PORT, bam)[mode]
    assert got == TP.hint_texts("augustus_tpu", bam)[mode]
    i = list(TP.HINT_MODES).index(mode)
    assert got == TP.golden(TP.GOLDENS["pipeline_hints"][i])
    assert "mult=" in got


def test_join_mult_hints_equal_on_exon_hints(bam):
    buf = io.StringIO()
    pb2h.Bam2Hints(introns_only=False, ss_on=True).run(bam, buf)
    lines = TP.sort_hints(buf.getvalue().splitlines())
    got = phg.join_mult_hints(lines)
    assert got == jhg.join_mult_hints(lines)
    assert len(got) < len(lines)


@pytest.mark.parametrize("trackname,region", [
    (None, None), ("rna", "HS04636:2000-7000"), ("t2", "HS08198")])
def test_bam_to_wig_equal(bam, trackname, region):
    got, want = io.StringIO(), io.StringIO()
    pwig.bam_to_wig(bam, got, trackname, region)
    jwig.bam_to_wig(bam, want, trackname, region)
    assert got.getvalue() == want.getvalue()
    assert "variableStep chrom=" in got.getvalue()


def test_psl_to_wig_equal():
    lines = F.psl_lines()
    got, want = io.StringIO(), io.StringIO()
    pwig.psl_to_wig(lines, got, trackname="aln")
    jwig.psl_to_wig(lines, want, trackname="aln")
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("variableStep") == 2
