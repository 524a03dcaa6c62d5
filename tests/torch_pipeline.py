"""Runs of the pipeline and protein-profile tools of either package on the
seeded inputs of torch_pipeline_fixtures.py: the tests of
augustus_tpu_torch/pipeline and augustus_tpu_torch/ppx run them with both
packages, tests/torch_goldens.py writes augustus_tpu's text as the goldens,
and chip_smoke.py runs the port's on the card against those goldens.

`pkg` is "augustus_tpu" (JAX on the CPU, `engine="scan"`, as the other
goldens are made) or "augustus_tpu_torch" (on `device`); the port's runs
import nothing of augustus_tpu or JAX.
"""

import contextlib
import gzip
import importlib
import io
import os
import shutil

import torch_pipeline_fixtures as F

ROOT = F.ROOT
DATA = F.DATA
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN_DIR = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
PORT = "augustus_tpu_torch"
EXTRINSIC = "extrinsic.M.RM.E.W.cfg"
# pipeline_hints: the two bam2hints runs (intron mode, --exonhints)
HINT_MODES = {"introns": {}, "exonhints": {"introns_only": False}}
# chunks: the sequences cut, the chunk size and overlap (at least three
# overlapping jobs per sequence)
CHUNK_FASTAS = ("HS04636.fa", "HS08198.fa")
CHUNK_SIZE, CHUNK_OVERLAP = 1000, 300
# optimize: the training set, the folds, the metaparameters and the
# files of the last training
OPT_SET = "genes_crf3.gb"
OPT_KFOLD = 3
OPT_PARS = (("/ExonModel/k", ("3", "4")),
            ("/Constant/dss_end", ("3", "4", "5")))
OPT_FILES = ("exon", "intron", "igenic")
# the goldens of each phase by name
GOLDENS = {
    "pipeline_hints": ("pipeline_hints_introns.gff",
                       "pipeline_hints_exonhints.gff",
                       "pipeline_HS04636_introns.gff",
                       "pipeline_HS04636_exonhints.gff"),
    "chunks": ("pipeline_chunks_joined.gff",),
    "optimize": ("pipeline_optimize.out",) + tuple(
        f"pipeline_optimize_{m}_probs.pbl.gz" for m in OPT_FILES),
    "ppx": ("ppx_fastblock.out", "ppx_simscore.out", "ppx_prepare_align.out",
            "ppx_profile.prfl"),
}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def golden(name: str) -> str:
    """The text of a golden (a name ending in .gz is gzipped)."""
    path = os.path.join(GOLDEN_DIR, name)
    with (gzip.open(path, "rt") if name.endswith(".gz") else
          open(path)) as fh:
        return fh.read()


def write_golden(name: str, text: str) -> str:
    """Write a golden (gzipped with mtime 0 for a name ending in .gz, so
    that the same text gives the same bytes); returns its path."""
    path = os.path.join(GOLDEN_DIR, name)
    if name.endswith(".gz"):
        with gzip.GzipFile(path, "wb", mtime=0) as fh:
            fh.write(text.encode())
    else:
        with open(path, "w") as fh:
            fh.write(text)
    return path


def strip_comments(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def sort_hints(lines) -> list:
    """Hint lines in the order join_mult_hints.pl takes them (AUGUSTUS'
    documented pipe: sort -n -k 4,4 | sort -s -n -k 5,5 | sort -s -k 3,3 |
    sort -s -k 1,1), that is by sequence, feature, end and start."""
    def key(line):
        f = line.split("\t")
        return (f[0], f[2], int(f[4]), int(f[3]))
    return sorted(lines, key=key)


def hint_texts(pkg: str, bam: str) -> dict:
    """{mode: joined hints text} of HINT_MODES: Bam2Hints, sorted, merged
    by join_mult_hints."""
    b2h = mod(pkg, "pipeline.bam2hints")
    jm = mod(pkg, "pipeline.hints_gen").join_mult_hints
    out = {}
    for mode, kw in HINT_MODES.items():
        buf = io.StringIO()
        b2h.Bam2Hints(**kw).run(bam, buf)
        out[mode] = "".join(l + "\n" for l in jm(
            sort_hints(buf.getvalue().splitlines())))
    return out


def hinted_args(hints_path: str) -> dict:
    return {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0", "hintsfile": hints_path,
            "extrinsicCfgFile": EXTRINSIC}


def predict(pkg: str, args: dict, path: str, device=None) -> str:
    p = mod(pkg, "predict")
    model = p.Model.load(dict(args))
    if pkg == PORT:
        return p.predict_file(model, path, device=device)
    return p.predict_file(model, path, engine="scan")


def pipeline_hints(pkg: str, tmp: str, device=None) -> dict:
    """{golden name: text} of the pipeline_hints phase: the BAM's two hint
    sets and HS04636.fa predicted with each."""
    bam = F.write_bam(os.path.join(tmp, "reads.bam"))
    texts = hint_texts(pkg, bam)
    names = GOLDENS["pipeline_hints"]
    out = {}
    for i, mode in enumerate(HINT_MODES):
        path = os.path.join(tmp, f"hints_{mode}.gff")
        with open(path, "w") as fh:
            fh.write(texts[mode])
        out[names[i]] = texts[mode]
        out[names[2 + i]] = predict(pkg, hinted_args(path), os.path.join(
            DATA, "HS04636.fa"), device)
    return out


def chunk_jobs(pkg: str, tmp: str) -> list:
    """[(FASTA, seqname, start, end)] of the chunks phase: the two
    sequences in one multi-FASTA, split into a file each, each cut into
    overlapping jobs."""
    ch = mod(pkg, "pipeline.chunking")
    os.makedirs(tmp, exist_ok=True)
    genome = os.path.join(tmp, "genome.fa")
    with open(genome, "w") as out:
        for name in CHUNK_FASTAS:
            with open(os.path.join(DATA, name)) as fh:
                out.write(fh.read())
    jobs = []
    for path in ch.split_mfasta(genome, os.path.join(tmp, "split"),
                                min_size=1):
        for seqname, start, end in ch.make_joblist(path, CHUNK_SIZE,
                                                   CHUNK_OVERLAP):
            jobs.append((path, seqname, start, end))
    return jobs


def chunk_args(start: int, end: int) -> dict:
    return {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0", "predictionStart": str(start),
            "predictionEnd": str(end)}


def chunks(pkg: str, tmp: str, device=None) -> dict:
    """{golden name: text} of the chunks phase: every job predicted with
    --predictionStart/--predictionEnd, the outputs merged by
    join_aug_pred."""
    ch = mod(pkg, "pipeline.chunking")
    outs = [predict(pkg, chunk_args(s, e), path, device)
            for path, _, s, e in chunk_jobs(pkg, tmp)]
    return {GOLDENS["chunks"][0]: ch.join_aug_pred(outs)}


def make_config(dst: str, pkg: str, species: str) -> str:
    """dst/model and dst/species/generic from the port's fixture config,
    then `pkg`'s create_species(species); returns dst."""
    shutil.copytree(os.path.join(CONFIG, "model"), os.path.join(dst, "model"))
    shutil.copytree(os.path.join(CONFIG, "species", "generic"),
                    os.path.join(dst, "species", "generic"))
    mod(pkg, "training.new_species").create_species(species, dst,
                                                    silent=True)
    return dst


def optimize(pkg: str, tmp: str, gb: str, pars, kfold: int, device=None,
             species: str = "opt"):
    """`pkg`'s optimize on `gb` with the metaparameters `pars`, trained from
    the template species `generic` in a configuration under tmp: (chosen
    values, the '# optimize:' lines it wrote to stderr, {file: text} of the
    species' .pbl files after its last training, training's stdout)."""
    cfg = make_config(os.path.join(tmp, "cfg"), pkg, species)
    metapars = F.write_metapars(os.path.join(tmp, "metapars.cfg"), pars)
    opt = mod(pkg, "pipeline.optimize")
    kw = {"device": device} if pkg == PORT else {"engine": "scan"}
    err, log = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(log):
        chosen = opt.optimize(species, cfg, gb, metapars_path=metapars,
                              kfold=kfold, rounds=1,
                              workdir=os.path.join(tmp, "work"), **kw)
    lines = [l for l in err.getvalue().splitlines()
             if l.startswith("# optimize:")]
    d = os.path.join(cfg, "species", species)
    files = {}
    for m in OPT_FILES:
        with open(os.path.join(d, f"{species}_{m}_probs.pbl")) as fh:
            files[m] = fh.read()
    return chosen, lines, files, log.getvalue()


def optimize_text(chosen: dict, lines) -> str:
    """The optimize golden's text: the stderr score lines, then the chosen
    values as the command line prints them."""
    return "".join(l + "\n" for l in lines) + "".join(
        f"{k}\t{v}\n" for k, v in chosen.items())


def optimize_phase(pkg: str, tmp: str, device=None) -> dict:
    """{golden name: text} of the optimize phase."""
    chosen, lines, files, _ = optimize(pkg, tmp, os.path.join(DATA, OPT_SET),
                                       OPT_PARS, OPT_KFOLD, device)
    names = GOLDENS["optimize"]
    out = {names[0]: optimize_text(chosen, lines)}
    for name, m in zip(names[1:], OPT_FILES):
        out[name] = files[m]
    return out


def run_main(main, argv) -> str:
    """The standard output of a command line's main(argv), which must
    return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main{argv}: exit {rc}")
    return buf.getvalue()


def ppx(pkg: str, tmp: str) -> dict:
    """{golden name: text} of the ppx phase: the profile msa2prfl builds
    from the seeded MSA with the generated q_ij (with [intron profile]
    sections added), fastBlockSearch of HS04636.fa and its reverse
    complement against it, pp_simScore of the protein with and without the
    inter-block intron weight, prepareAlign of the MSA with a gap-riddled
    row."""
    p = F.write_ppx(os.path.join(tmp, "ppx"))
    m2p = mod(pkg, "ppx.msa2prfl")
    with open(p["msa"]) as fh:
        _, rows = m2p.read_msa(fh)
    prfl = F.add_intron_profiles(
        m2p.msa_to_prfl(rows, name="fixture", qij_path=p["qij"]), rows,
        p["where"], p["introns"])
    prfl_path = os.path.join(tmp, "ppx", "fixture.prfl")
    with open(prfl_path, "w") as fh:
        fh.write(prfl)
    names = GOLDENS["ppx"]
    fbs = mod(pkg, "cli.fastBlockSearch").main
    sim = mod(pkg, "cli.pp_simScore").main
    prep = mod(pkg, "cli.prepareAlign").main
    sim_args = ["--fasta", p["protein"], "--prfl", prfl_path]
    return {
        names[0]: run_main(fbs, ["--cutoff=0.5", p["genome"], prfl_path]),
        names[1]: run_main(sim, sim_args) + run_main(
            sim, sim_args + ["--intron_weight_inter=0"]) + run_main(
            sim, sim_args + ["--out=consents"]),
        names[2]: run_main(prep, [p["msa_gappy"]]),
        names[3]: prfl}
