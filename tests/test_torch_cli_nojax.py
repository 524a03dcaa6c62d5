"""Every command line of the port runs with JAX refused: each runs in a
subprocess whose import hook raises on `jax`, `jaxlib` and `augustus_tpu`
(and which fails if any of them was loaded), on inputs of a few kb with
--device=cpu where the command takes one; it must exit 0 and print what
the same main() prints in this process.  load2db runs over the stand-in
`pymysql` module of torch_cgp_fixtures.write_mysql_stub, put on the
PYTHONPATH of its subprocess and on sys.path for its in-process run only."""

import contextlib
import importlib
import io
import os
import subprocess
import sys

import pytest

import torch_cgp_fixtures as CF
import torch_pipeline as TP
import torch_pipeline_fixtures as F

ROOT = TP.ROOT
DATA = TP.DATA
CONFIG = TP.CONFIG

HOOK = r"""
import importlib.abc, runpy, sys
REFUSED = ("jax", "jaxlib", "augustus_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused to import {name}")
        return None


sys.meta_path.insert(0, Refuse())
mod, args = sys.argv[1], sys.argv[2:]
sys.argv = [mod] + args
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
finally:
    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    if loaded:
        sys.stderr.write(f"loaded: {loaded}\n")
        sys.exit(3)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The commands' inputs: the seeded BAM, its hints and PSL lines, the
    protein-profile files, two small GenBank records, a configuration
    with the species `sp` made from the template `generic`, the seeded
    cgp input of one gene range and the stand-in `pymysql` module."""
    from augustus_tpu_torch.pipeline.bam2hints import Bam2Hints
    from augustus_tpu_torch.pipeline.trainprep import gff2gb
    d = tmp_path_factory.mktemp("cli")
    p = {"dir": str(d), "bam": F.write_bam(str(d / "reads.bam"))}
    # the comparative run's input: one gene range (HS08198's) of three
    # species
    from torch_cgp_fixtures import write_cgp
    p["cgp"] = write_cgp(str(d / "cgp"), seqids=("HS08198",))
    p["mysql_stub"] = CF.write_mysql_stub(str(d / "mysql_stub"))
    hints = io.StringIO()
    Bam2Hints(introns_only=False).run(p["bam"], hints)
    p["hints"] = str(d / "hints.gff")
    with open(p["hints"], "w") as fh:
        fh.write("".join(l + "\n" for l in TP.sort_hints(
            hints.getvalue().splitlines())))
    p["psl"] = "".join(F.psl_lines())
    p.update(F.write_ppx(str(d / "ppx")))
    from augustus_tpu_torch.ppx.msa2prfl import msa_to_prfl, read_msa
    with open(p["msa"]) as fh:
        _, rows = read_msa(fh)
    p["prfl"] = str(d / "fixture.prfl")
    with open(p["prfl"], "w") as fh:
        fh.write(msa_to_prfl(rows, name="fixture", qij_path=p["qij"]))
    p["gb"] = F.write_small_gb(str(d / "gb"), gff2gb)
    p["cfg"] = TP.make_config(str(d / "cfg"), TP.PORT, "sp")
    p["metapars"] = F.write_metapars(str(d / "metapars.cfg"),
                                     (("/Constant/dss_end", ("4",)),))
    with open(os.path.join(TP.GOLDEN_DIR, "repo_fixture_HS04636.gff")) as fh:
        p["gtf"] = fh.read()
    p["transmap"] = str(d / "tm.gp")
    with open(p["transmap"], "w") as fh:
        fh.write("mrna1-1\tchr1\t+\t1000\t5000\t1500\t4500\t3\t"
                 "1000,2500,4000,\t2000,3000,5000,\t0\tx\tcmpl\tcmpl\t"
                 "0,1,2\t1,1,\n")
    return p


def _gb_fa(p):
    return os.path.join(os.path.dirname(p["gb"]), "HS08198.fa")


def _gb_gff(p):
    return os.path.join(os.path.dirname(p["gb"]), "HS08198.gff")


# (test id, module, arguments from the inputs, standard input from them)
CASES = [
    ("augustus", "augustus_tpu_torch.cli.augustus", lambda p: [
        "--species=repo_fixture", f"--AUGUSTUS_CONFIG_PATH={CONFIG}",
        "--UTR=off", "--softmasking=0", "--device=cpu",
        "--predictionStart=401", "--predictionEnd=1800",
        os.path.join(DATA, "HS08198.fa")], None),
    ("augustus_cgp", "augustus_tpu_torch.cli.augustus", lambda p: [
        "--species=repo_fixture", f"--AUGUSTUS_CONFIG_PATH={CONFIG}",
        "--UTR=off", "--softmasking=0", "--device=cpu",
        f"--alnfile={p['cgp']['aln']}", f"--treefile={p['cgp']['tree']}",
        f"--speciesfilenames={p['cgp']['tbl']}",
        f"--/CompPred/outdir={os.path.join(p['dir'], 'cgp_out')}"], None),
    ("etraining", "augustus_tpu_torch.cli.etraining", lambda p: [
        p["gb"], "--species=sp", f"--AUGUSTUS_CONFIG_PATH={p['cfg']}",
        "--device=cpu"], None),
    ("evaluate", "augustus_tpu_torch.cli.evaluate",
     lambda p: [p["gb"], p["gb"]], None),
    ("bam2hints", "augustus_tpu_torch.cli.bam2hints",
     lambda p: [f"--in={p['bam']}", "--exonhints"], None),
    ("fastBlockSearch", "augustus_tpu_torch.cli.fastBlockSearch",
     lambda p: ["--cutoff=0.5", p["genome"], p["prfl"]], None),
    ("pp_simScore", "augustus_tpu_torch.cli.pp_simScore",
     lambda p: ["--fasta", p["protein"], "--prfl", p["prfl"]], None),
    ("prepareAlign", "augustus_tpu_torch.cli.prepareAlign",
     lambda p: [p["msa_gappy"]], None),
    ("chunking_split", "augustus_tpu_torch.pipeline.chunking",
     lambda p: ["split", os.path.join(DATA, "HS04636.fa"),
                os.path.join(p["dir"], "split"), "1"], None),
    ("chunking_join", "augustus_tpu_torch.pipeline.chunking",
     lambda p: ["join", os.path.join(TP.GOLDEN_DIR,
                                     "repo_fixture_HS04636.gff"),
                os.path.join(TP.GOLDEN_DIR,
                             "repo_fixture_HS04636_mea.gff")], None),
    ("convert_gb2gff", "augustus_tpu_torch.pipeline.convert",
     lambda p: ["gb2gff", p["gb"]], None),
    ("convert_summarize", "augustus_tpu_torch.pipeline.convert",
     lambda p: ["summarizeACGT", os.path.join(DATA, "HS04636.fa")], None),
    ("convert_gtf2gff3", "augustus_tpu_torch.pipeline.convert",
     lambda p: ["gtf2gff3"], lambda p: p["gtf"]),
    ("convert_getprot", "augustus_tpu_torch.pipeline.convert",
     lambda p: ["getprot"], lambda p: p["gtf"]),
    ("hints_joinmult", "augustus_tpu_torch.pipeline.hints_gen",
     lambda p: ["joinmult"], lambda p: open(p["hints"]).read()),
    ("hints_psl2hints", "augustus_tpu_torch.pipeline.hints_gen",
     lambda p: ["psl2hints"], lambda p: p["psl"]),
    ("hints_filter_splice", "augustus_tpu_torch.pipeline.hints_gen",
     lambda p: ["filterSpliceHints", os.path.join(DATA, "HS04636.fa"),
                p["hints"]], None),
    ("trainprep_gff2gb", "augustus_tpu_torch.pipeline.trainprep",
     lambda p: ["gff2gb", _gb_gff(p), _gb_fa(p), "200",
                os.path.join(p["dir"], "cut.gb")], None),
    ("trainprep_randomsplit", "augustus_tpu_torch.pipeline.trainprep",
     lambda p: ["randomsplit", p["gb"], "1"], None),
    ("transmap2hints", "augustus_tpu_torch.pipeline.transmap2hints",
     lambda p: [f"--in={p['transmap']}"], None),
    ("wig_bam2wig", "augustus_tpu_torch.pipeline.wig",
     lambda p: ["bam2wig", "-t", "rna", p["bam"]], None),
    ("wig_aln2wig", "augustus_tpu_torch.pipeline.wig",
     lambda p: ["aln2wig"], lambda p: p["psl"]),
    ("msa2prfl", "augustus_tpu_torch.ppx.msa2prfl",
     lambda p: [f"--qij={p['qij']}", "--name=fx", p["msa"]], None),
    ("optimize", "augustus_tpu_torch.pipeline.optimize", lambda p: [
        "--species=sp", f"--AUGUSTUS_CONFIG_PATH={p['cfg']}",
        f"--metapars={p['metapars']}", "--kfold=2",
        f"--workdir={os.path.join(p['dir'], 'opt')}", "--device=cpu",
        p["gb"]], None),
    ("getSeq", "augustus_tpu_torch.cli.getSeq", lambda p: [
        "--species=mutC", "--seq=HS08198", f"--dbaccess={p['cgp']['db']}",
        "--start=941", "--end=1070", "--rc"], None),
    ("load2sqlitedb", "augustus_tpu_torch.cli.load2sqlitedb", lambda p: [
        "--species=hs", f"--dbaccess={os.path.join(p['dir'], 'cli.db')}",
        "--chunksize=1000", p["cgp"]["genomes"]["hs"]], None),
    ("load2db", "augustus_tpu_torch.cli.load2db", lambda p: [
        "--species=hs", "--dbaccess=nojax,localhost,user,secret",
        p["cgp"]["genomes"]["hs"]], None),
]
# the cases that import the stand-in `pymysql` module
ON_STUB = ("load2db",)


def _in_process(module, argv, stdin, stub=None) -> str:
    out = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()), \
                (CF.mysql_stub_on_path(stub) if stub
                 else contextlib.nullcontext()):
            rc = importlib.import_module(module).main(argv)
    finally:
        sys.stdin = saved
    assert rc in (0, None), f"{module}.main returned {rc}"
    return out.getvalue()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cli_runs_with_jax_refused(inputs, case):
    _, module, args, stdin = case
    argv = args(inputs)
    text = stdin(inputs) if stdin else None
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    stub = inputs["mysql_stub"] if case[0] in ON_STUB else None
    if stub:
        env["PYTHONPATH"] = stub
    r = subprocess.run([sys.executable, "-c", HOOK, module] + argv,
                       input=text or "", capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = _in_process(module, argv, text, stub)
    assert r.stdout == want
    assert r.stdout or module.endswith("trainprep")
