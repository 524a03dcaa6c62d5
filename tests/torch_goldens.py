"""Write the port's golden GFFs, made on the CPU.

    python3 tests/torch_goldens.py [hs04636] [tiled] [hints] [tiled_hints] \
        [sample] [sample_hints] [sample_depth] [mea] [mea_hints] \
        [mea_nologreg] [mea_depth] [eval_test1] [eval_crf3] [tiled_sm] \
        [utr_hs04636] [utr_hints] [utr_rc] [utr_eval] [utr_tiled] \
        [utr_sample] [utr_sample_hints] [utr_mea] [utr_sample_depth] \
        [nc_hints] [nc_plain] [nc_fixture] [tiled_pieces] [utr_pieces] \
        [utr_pieces_hints] [utr_pieces_segments] [train_crf3] [train_utr] \
        [pipeline_hints] [chunks] [optimize] [ppx] [capacity_slots] \
        [capacity_deep] [capacity_deep_utr] [wide_intron] [nc_two_starts] \
        [nc_alt_donors] [cgp]

All use the `repo_fixture` species with `--UTR=off`; hs04636, tiled and
sample with `--softmasking=0` and no hints, hints, tiled_hints and
sample_hints with `--softmasking=1`, a hints file of
augustus_tpu_torch/data/hints/ and extrinsic.M.RM.E.W.cfg:
  hs04636  tests/data/HS04636.fa through `augustus_tpu` predict_file
           (engine="scan", JAX on the CPU)
           -> augustus_tpu_torch/data/golden/repo_fixture_HS04636.gff
  tiled    the 1,023,095-base sequence of augustus_tpu_torch/io/tiled.py
           through the port's own CPU path, predict_records(device="cpu"),
           where the plain PyTorch version of each kernel runs
           -> augustus_tpu_torch/data/golden/repo_fixture_tiled.gff
  hints    tests/data/HS04636sm.fa with HS04636sm.E.gff through
           `augustus_tpu` predict_file(engine="scan")
           -> augustus_tpu_torch/data/golden/repo_fixture_HS04636sm_hints.gff
  tiled_hints  io/tiled.py:tiled_hinted (the same letters softmasked, with
           tiled_sm.E.gff) through the port's CPU path
           -> augustus_tpu_torch/data/golden/repo_fixture_tiled_hints.gff
  sample   tests/data/HS04636.fa with --sample=100
           --alternatives-from-sampling=true through the port's CPU path
           (plain versions of the Viterbi and forward kernels, the host
           sampling walk; about a minute)
           -> augustus_tpu_torch/data/golden/repo_fixture_HS04636_sample100.gff
           (tests/test_torch_sampling.py keeps it equal to `augustus_tpu`)
  sample_hints  tests/data/HS04636sm.fa with HS04636sm.E.gff, sampled as
           above with the posterior filters --minexonintronprob=0.08
           --minmeanexonintronprob=0.4 --keep_viterbi=true, the port's CPU
           path -> repo_fixture_HS04636sm_hints_sample100.gff
           (tests/test_torch_sampling_hints.py keeps it equal to
           `augustus_tpu`)
  sample_depth  the first SAMPLE_DEPTH = 21,000 bases of the tiled
           sequence, sampled as `sample`, the port's CPU path (a few
           minutes) -> repo_fixture_tiled21k_sample100.gff
           (tests/test_torch_sampling.py keeps it equal to `augustus_tpu`
           in a test marked slow)
  mea      tests/data/HS04636.fa with --mea=1 (100 sampled paths, the
           transcripts of the maximum expected accuracy path), the port's
           CPU path -> repo_fixture_HS04636_mea.gff
  mea_hints  tests/data/HS04636sm.fa with HS04636sm.E.gff and --mea=1
           -> repo_fixture_HS04636sm_hints_mea.gff
  mea_nologreg  as mea with --/CompPred/logreg=false (the piecewise-linear
           scores of the posteriors) -> repo_fixture_HS04636_mea_nologreg.gff
           (tests/test_torch_mea.py, test_torch_mea_hints.py and
           test_torch_mea_scoring.py keep these three equal to
           `augustus_tpu`)
  mea_depth  sample_depth's letters with --mea=1
           -> repo_fixture_tiled21k_mea.gff (kept equal to `augustus_tpu`
           by a test marked slow)
  eval_test1, eval_crf3  the GenBank sets tests/data/genes_test1.gb (1
           record) and genes_crf3.gb (3 records) through the port's
           evaluate_genbank on the CPU (softmasking off, as the command line
           sets it for GenBank input): annotation, prediction and accuracy
           tables -> repo_fixture_eval_test1.out, repo_fixture_eval_crf3.out
           (tests/test_torch_evaluation.py keeps them equal to
           `augustus_tpu`, the whole sets in a test marked slow)
  tiled_sm the letters of tiled_hints with the hints of tiled_sm.E.gff
           without their exonpart, CDSpart, exon and CDS lines
           (io/tiled.py:exon_free_hints; chip_smoke.py's full_sm), the
           port's CPU path -> repo_fixture_tiled_sm.gff
The UTR goldens use the `repo_fixture_utr` species (71 states, written by
augustus_tpu_torch/data/make_utr_fixture.py) with `--UTR=on`:
  utr_hs04636  tests/data/HS04636.fa with --print_utr=on through
           `augustus_tpu` predict_file(engine="scan")
           -> repo_fixture_utr_HS04636.gff
  utr_hints  HS04636sm.fa softmasked with HS04636sm.E.gff, the same way
           -> repo_fixture_utr_HS04636sm_hints.gff
  utr_rc   HS04636rc.fa with --print_utr=on, the same way
           -> repo_fixture_utr_HS04636rc.gff
  utr_eval  the GenBank set tests/data/utrtrain.gb through `augustus_tpu`
           evaluate_genbank(engine="scan") -> repo_fixture_utr_eval_utrtrain.out
           (tests/test_torch_utr.py keeps the port's four texts equal to
           these; a test marked slow recomputes them with `augustus_tpu`)
  utr_tiled  the tiled sequence with --print_utr=on through the port's CPU
           path -> repo_fixture_utr_tiled.gff (`augustus_tpu`'s scan took
           364 s for its first 80,000 bases on a CPU, 4.5 ms per
           base against 1.7 on HS04636.fa: its time per base grows with the
           length, so 1 Mb would take hours; a test marked slow keeps the
           first 21,000 bases equal between the two packages)
  utr_sample  tests/data/HS04636.fa with --print_utr=on --sample=100
           --alternatives-from-sampling=true through `augustus_tpu`
           predict_file(engine="scan") -> repo_fixture_utr_HS04636_sample100.gff
  utr_sample_hints  HS04636sm.fa softmasked with HS04636sm.E.gff, sampled
           with the posterior filters of sample_hints, the same way
           -> repo_fixture_utr_HS04636sm_hints_sample100.gff
  utr_mea  HS04636.fa with --print_utr=on --mea=1
           --/CompPred/logreg=false, the same way
           -> repo_fixture_utr_HS04636_mea_nologreg.gff
           (tests/test_torch_utr_sampling.py, test_torch_utr_sampling_hints.py
           and test_torch_utr_mea.py keep the port's texts equal to these;
           tests marked slow recompute them with `augustus_tpu`)
  utr_sample_depth  sample_depth's letters sampled as utr_sample, through
           the port's CPU path -> repo_fixture_utr_tiled21k_sample100.gff
           (kept equal to `augustus_tpu` by a test marked slow)
Two goldens of pieces decoded in flight (augustus_tpu_torch/parallel), the
port's CPU path, predict_records(device="cpu"):
  tiled_pieces  the tiled sequence as `tiled` with --maxDNAPieceSize=100000
           (11 pieces; about 25 minutes on one thread)
           -> repo_fixture_tiled_pieces100k.gff
  utr_pieces  the first UTR_PIECES_LEN = 100,000 bases of the tiled
           sequence as `utr_tiled` with --maxDNAPieceSize=20000 (5 pieces
           through K2's plain version) -> repo_fixture_utr_tiled100k_pieces20k.gff
and one of `augustus_tpu`, on the 8 virtual CPU devices of tier-1
(tests/conftest.py), where its predict_sequence decodes the pieces with
its mesh's decode_pieces:
  utr_pieces_hints  bases 501-3,500 of HS04636sm.fa softmasked with
           HS04636sm.E.gff, --UTR=on --print_utr=on, --maxDNAPieceSize=1500
           (two pieces, a gene) -> repo_fixture_utr_HS04636sm_hints_pieces1500.gff
           (tests/test_torch_parallel_gff_utr.py keeps the port's text, in
           flight and piece after piece, equal to it; a test marked slow
           recomputes it with `augustus_tpu`)
  utr_pieces_segments  augustus_tpu's parallel.mesh.decode_pieces of the
           first 6,000 bases of HS04636sm.fa with HS04636sm.E.gff in four
           pieces of 1,500 (tests/torch_pieces.py), each path condensed, as
           JSON -> repo_fixture_utr_HS04636sm_hints_pieces1500.json
           (tests/test_torch_parallel_utr.py holds the port's decode_pieces
           to it; its JAX scan takes about 2 minutes on a CPU, so a test
           marked slow recomputes it)
The ncRNA goldens use `repo_fixture_utr` with `--nc=on` (83 states, the
architecture written by augustus_tpu_torch/data/make_nc_fixture.py) and
--print_utr=on (tests/torch_nc_check.py:nc_run):
  nc_plain  tests/data/HS08198.fa without hints through `augustus_tpu`
           predict_file(engine="auto"), its host gold engine
           -> repo_fixture_utr_nc_HS08198.gff
  nc_hints  tests/data/HS04636.fa with tests/data/nc_hints.gff and
           extrinsic.M.RM.E.W.cfg, the port's CPU path
           -> repo_fixture_utr_nc_HS04636_hints.gff
  nc_fixture  tests/data/HS08198.fa with the hint fixture HS08198.nc.gff
           and extrinsic.M.RM.E.W.nc.cfg, the port's CPU path
           -> repo_fixture_utr_nc_HS08198_fixture.gff
  augustus_tpu prints no text for the last two: its
  output/genes.py:project_onto_genes does not advance past an nc exon, so
  a path with a noncoding transcript never leaves it.
  tests/test_torch_nc_decode.py and test_torch_nc_hints.py hold the port's
  decode of all three to augustus_tpu's GoldEngine (segments, values,
  backpointers) and the printed nc transcript of nc_hints to the AUGUSTUS
  3.5.0 text of tests/data/golden_human_nc_hints_HS04636.gff.
The training goldens are `augustus_tpu`'s, each species trained in a
temporary configuration made from the template species `generic`
(augustus_tpu_torch/data/make_train_fixture.py; tests/torch_training.py),
gzipped, named train_<set><file>.gz:
  train_crf3  run_training on tests/data/genes_crf3.gb with --CRF=on (two
           rounds; its engine "auto" is the XLA scan engine on a CPU): the
           exon, intron and intergenic .pbl and the .pbl.HMM copies of the
           maximum-likelihood exon and intron files; then that species'
           predict_file(engine="scan") of tests/data/HS04636.fa
           (_HS04636.gff) and evaluate_genbank(engine="scan") of
           tests/data/genes_test1.gb (_eval_test1.out); about 2 minutes
  train_utr  run_training on tests/data/utrtrain.gb with --UTR=on
           --/EHMMTraining/statecount=4: the four .pbl files; then that
           species' HS04636.fa with --UTR=on --print_utr=on (_HS04636.gff)
  (tests/test_torch_training_crf.py holds the port's CPU predictions with
  the golden species to the texts, and recomputes every file with both
  packages in tests marked slow; chip_smoke.py's train phase holds the
  card to all of them)
The pipeline and protein-profile goldens are `augustus_tpu`'s (JAX on the
CPU, engine="scan"), run on the seeded inputs of
tests/torch_pipeline_fixtures.py by tests/torch_pipeline.py (its GOLDENS
name the files of each):
  pipeline_hints  bam2hints of the generated RNA-seq BAM in intron mode
           and with --exonhints, each sorted and merged by join_mult_hints,
           and HS04636.fa predicted with each hint set and
           extrinsic.M.RM.E.W.cfg (about 3 minutes)
  chunks   HS04636.fa and HS08198.fa split by split_mfasta, cut into
           overlapping jobs by make_joblist, each job predicted with
           --predictionStart/--predictionEnd, merged by join_aug_pred
  optimize  optimize on tests/data/genes_crf3.gb (3 folds, the
           metaparameters of torch_pipeline.OPT_PARS) from the template
           species `generic`: its score lines, the chosen values and the
           .pbl files of its last training
  ppx      the profile msa2prfl builds from the seeded MSA and q_ij table
           (with [intron profile] sections), fastBlockSearch of HS04636.fa
           and its reverse complement, pp_simScore of the fixture protein,
           prepareAlign of the MSA with a gap-riddled row
  (tests/test_torch_pipeline.py, test_torch_bam2hints.py,
  test_torch_ppx.py and test_torch_optimize.py hold the port to
  augustus_tpu on smaller inputs and on these; chip_smoke.py's
  pipeline_hints, chunks, optimize and ppx phases hold the card to them)
The capacity and cgp goldens (PR 16): capacity_slots (70 stacked exonpart
hints, tests/torch_capacity_fixtures.py) and wide_intron (HS04636.fa
sampled with repo_fixture_wide) are `augustus_tpu`'s (about 3.5 and 1
minutes); capacity_deep and capacity_deep_utr (1,300 hints; augustus_tpu's
CPU scan took 203 s at 70 and grows with the depth) and nc_two_starts / nc_alt_donors
(tests/torch_nc_check.py:write_multi_hints; augustus_tpu prints no
noncoding transcript) the port's CPU path; cgp writes cgp_<file> for the
six files of augustus_tpu's CompGenePred.start on
tests/torch_cgp_fixtures.py's input (about 45 s).
The tiled goldens do not come from `augustus_tpu`: the time per position
of its XLA scan on the CPU grows with the length, so 1 Mb takes hours.  The
port's CPU path equals `augustus_tpu` on every smaller input that
tests/test_torch_*.py hold them to; at 1 Mb it takes about 17 minutes on
one thread and 13 GB of memory, so run it where that is free.  Each golden
prints its seconds and the process's peak resident memory.
`chip_smoke.py` holds the card's output equal to every golden.
"""

import os
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
# tier-1's virtual devices (tests/conftest.py)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN_DIR = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
GOLDENS = {"hs04636": "repo_fixture_HS04636.gff",
           "tiled": "repo_fixture_tiled.gff",
           "hints": "repo_fixture_HS04636sm_hints.gff",
           "tiled_hints": "repo_fixture_tiled_hints.gff",
           "sample": "repo_fixture_HS04636_sample100.gff",
           "sample_hints": "repo_fixture_HS04636sm_hints_sample100.gff",
           "sample_depth": "repo_fixture_tiled21k_sample100.gff",
           "mea": "repo_fixture_HS04636_mea.gff",
           "mea_hints": "repo_fixture_HS04636sm_hints_mea.gff",
           "mea_nologreg": "repo_fixture_HS04636_mea_nologreg.gff",
           "mea_depth": "repo_fixture_tiled21k_mea.gff",
           "eval_test1": "repo_fixture_eval_test1.out",
           "eval_crf3": "repo_fixture_eval_crf3.out",
           "tiled_sm": "repo_fixture_tiled_sm.gff",
           "utr_hs04636": "repo_fixture_utr_HS04636.gff",
           "utr_hints": "repo_fixture_utr_HS04636sm_hints.gff",
           "utr_rc": "repo_fixture_utr_HS04636rc.gff",
           "utr_eval": "repo_fixture_utr_eval_utrtrain.out",
           "utr_tiled": "repo_fixture_utr_tiled.gff",
           "utr_sample": "repo_fixture_utr_HS04636_sample100.gff",
           "utr_sample_hints": "repo_fixture_utr_HS04636sm_hints_sample100.gff",
           "utr_mea": "repo_fixture_utr_HS04636_mea_nologreg.gff",
           "utr_sample_depth": "repo_fixture_utr_tiled21k_sample100.gff",
           "nc_plain": "repo_fixture_utr_nc_HS08198.gff",
           "nc_hints": "repo_fixture_utr_nc_HS04636_hints.gff",
           "nc_fixture": "repo_fixture_utr_nc_HS08198_fixture.gff",
           "tiled_pieces": "repo_fixture_tiled_pieces100k.gff",
           "utr_pieces": "repo_fixture_utr_tiled100k_pieces20k.gff",
           "utr_pieces_hints":
               "repo_fixture_utr_HS04636sm_hints_pieces1500.gff",
           "utr_pieces_segments":
               "repo_fixture_utr_HS04636sm_hints_pieces1500.json",
           "nc_two_starts": "repo_fixture_utr_nc_HS08198_two_starts.gff",
           "nc_alt_donors": "repo_fixture_utr_nc_HS08198_alt_donors.gff",
           "capacity_slots": "repo_fixture_capacity_slots.gff",
           "capacity_deep": "repo_fixture_capacity_deep.gff",
           "capacity_deep_utr": "repo_fixture_utr_capacity_deep.gff",
           "wide_intron": "repo_fixture_wide_HS04636_sample100.gff"}
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}
SAMPLED = dict(ARGS, sample="100")
SAMPLED["alternatives-from-sampling"] = "true"
# sampled with repo_fixture_wide, whose lessD window (79) K3 cannot hold
WIDE_SAMPLED = dict(SAMPLED, species="repo_fixture_wide")
# the posterior filters of the hinted sampled golden
FILTERS = {"minexonintronprob": "0.08", "minmeanexonintronprob": "0.4",
           "keep_viterbi": "true"}
SAMPLE_DEPTH = 21_000     # bases of the tiled sequence that sample_depth takes
MEA = dict(ARGS, mea="1")
NOLOGREG = dict(MEA, **{"/CompPred/logreg": "false"})
# the GenBank sets of eval_test1 and eval_crf3 (softmasking off, as the
# command line sets it for GenBank input)
EVAL_SETS = {"eval_test1": "genes_test1.gb", "eval_crf3": "genes_crf3.gb"}
UTR_ARGS = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "on", "softmasking": "0", "print_utr": "on"}
UTR_DEPTH = 21_000     # bases of the tiled sequence that the slow UTR test
#                        decodes with both packages
# the pieces goldens: the piece size of each and utr_pieces' letters
PIECES_ARGS = dict(ARGS, maxDNAPieceSize="100000")
UTR_PIECES_ARGS = dict(UTR_ARGS, maxDNAPieceSize="20000")
UTR_PIECES_LEN = 100_000
# utr_pieces_hints: the window of HS04636sm.fa and its piece size
UTR_PIECES_HINTS = {"predictionStart": "501", "predictionEnd": "3500",
                    "maxDNAPieceSize": "1500"}
UTR_SAMPLED = dict(UTR_ARGS, **{k: SAMPLED[k] for k in
                                ("sample", "alternatives-from-sampling")})


def utr_run(which: str):
    """(arguments, input path) of a UTR golden from augustus_tpu."""
    hinted = dict(hinted_args("HS04636sm.E.gff"), species="repo_fixture_utr",
                  UTR="on")
    hs04636 = os.path.join(DATA, "HS04636.fa")
    return {"utr_hs04636": (UTR_ARGS, hs04636),
            "utr_hints": (hinted, os.path.join(DATA, "HS04636sm.fa")),
            "utr_rc": (UTR_ARGS, os.path.join(DATA, "HS04636rc.fa")),
            "utr_pieces_hints": (dict(hinted, print_utr="on",
                                      **UTR_PIECES_HINTS),
                                 os.path.join(DATA, "HS04636sm.fa")),
            "utr_eval": (dict(UTR_ARGS, softmasking="0"),
                         os.path.join(DATA, "utrtrain.gb")),
            "utr_sample": (UTR_SAMPLED, hs04636),
            "utr_sample_hints": (dict(
                hinted, **FILTERS, **{k: UTR_SAMPLED[k] for k in (
                    "sample", "alternatives-from-sampling")}),
                os.path.join(DATA, "HS04636sm.fa")),
            "utr_mea": (dict(UTR_ARGS, mea="1",
                             **{"/CompPred/logreg": "false"}), hs04636)}[which]


def utr_reference(which: str) -> str:
    """augustus_tpu's text (engine="scan", JAX on the CPU) of a UTR golden
    of utr_run."""
    from augustus_tpu.predict import Model, evaluate_genbank, predict_file
    args, path = utr_run(which)
    if which == "utr_eval":
        return evaluate_genbank(Model.load(dict(args)), path, engine="scan")
    return predict_file(Model.load(dict(args)), path, engine="scan")


def exon_free_file(dst: str) -> str:
    """dst: the hints of data/hints/tiled_sm.E.gff without exonpart,
    CDSpart, exon and CDS lines (chip_smoke.py's full_sm input)."""
    from augustus_tpu_torch.io.tiled import exon_free_hints
    with open(os.path.join(HINTS, "tiled_sm.E.gff")) as fh:
        lines = exon_free_hints(fh.read().splitlines(True))
    with open(dst, "w") as fh:
        fh.write("".join(lines))
    return dst


def depth_record():
    """The first SAMPLE_DEPTH bases of io/tiled.py:tiled_record, under its
    name (chip_smoke.py's sample_depth piece)."""
    from augustus_tpu_torch.io.fasta import FastaRecord
    from augustus_tpu_torch.io.tiled import tiled_record
    rec = tiled_record(DATA)
    return FastaRecord(rec.name, rec.sequence[:SAMPLE_DEPTH])


def utr_pieces_record():
    """The first UTR_PIECES_LEN bases of io/tiled.py:tiled_record, under
    its name (utr_pieces' letters)."""
    from augustus_tpu_torch.io.fasta import FastaRecord
    from augustus_tpu_torch.io.tiled import tiled_record
    rec = tiled_record(DATA)
    return FastaRecord(rec.name, rec.sequence[:UTR_PIECES_LEN])


def hinted_args(hints_file: str) -> dict:
    return dict(ARGS, softmasking="1",
                hintsfile=os.path.join(HINTS, hints_file),
                extrinsicCfgFile="extrinsic.M.RM.E.W.cfg")


def mea_run(which: str):
    """(arguments, FASTA path or None for depth_record()) of an MEA golden."""
    return {"mea": (MEA, os.path.join(DATA, "HS04636.fa")),
            "mea_hints": (dict(hinted_args("HS04636sm.E.gff"), mea="1"),
                          os.path.join(DATA, "HS04636sm.fa")),
            "mea_nologreg": (NOLOGREG, os.path.join(DATA, "HS04636.fa")),
            "mea_depth": (MEA, None)}[which]


def body(text: str) -> str:
    """A GFF text without its comment lines, as the goldens compare it."""
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def eval_filter(text: str) -> list:
    """The lines of an evaluation text that its goldens compare, as
    tests/test_evaluation.py filters them: from the first '# ----- sequence
    number' line on, without time and command-line lines."""
    lines = text.split("\n")
    start = next(i for i, l in enumerate(lines)
                 if "# ----- sequence number" in l)
    return [l for l in lines[start:]
            if "# total time:" not in l and "command line" not in l]


def reference_gff(which: str) -> str:
    """augustus_tpu's text (engine="scan", JAX on the CPU) for the input of
    an MEA or evaluation golden."""
    import tempfile
    from augustus_tpu.predict import Model, evaluate_genbank, predict_file
    if which in EVAL_SETS:
        return evaluate_genbank(Model.load(dict(ARGS)),
                                os.path.join(DATA, EVAL_SETS[which]),
                                engine="scan")
    args, fasta = mea_run(which)
    with tempfile.TemporaryDirectory() as tmp:
        if fasta is None:
            rec = depth_record()
            fasta = os.path.join(tmp, "depth.fa")
            with open(fasta, "w") as fh:
                fh.write(f">{rec.name}\n{rec.sequence}\n")
        return predict_file(Model.load(dict(args)), fasta, engine="scan")


def golden_gff(which: str) -> str:
    """The GFF text of one golden, computed anew."""
    if which == "utr_pieces_segments":
        import json
        from augustus_tpu.predict import Model
        from torch_pieces import piece_inputs, reference_paths
        args, fasta = utr_run("utr_hints")
        jmodel = Model.load(dict(args, print_utr="on"))
        return json.dumps(reference_paths(jmodel, piece_inputs(
            "augustus_tpu", jmodel, fasta, 1500, 6000))) + "\n"
    if which == "wide_intron":
        from augustus_tpu.predict import Model, predict_file
        return predict_file(Model.load(dict(WIDE_SAMPLED)),
                            os.path.join(DATA, "HS04636.fa"), engine="scan")
    if which.startswith("capacity_"):
        import tempfile
        from torch_capacity_fixtures import capacity_run
        species = "repo_fixture_utr" if which.endswith("_utr") else \
            "repo_fixture"
        with tempfile.TemporaryDirectory() as tmp:
            args, fasta = capacity_run(which.split("_")[1], tmp, species)
            if which == "capacity_slots":
                from augustus_tpu.predict import Model, predict_file
                return predict_file(Model.load(args), fasta, engine="scan")
            import torch
            from augustus_tpu_torch.predict import Model, predict_file
            torch.set_num_threads(1)
            return predict_file(Model.load(args), fasta, device="cpu")
    if which.startswith("nc_"):
        from torch_nc_check import nc_run
        args, fasta = nc_run(which)
        if which == "nc_plain":
            from augustus_tpu.predict import Model, predict_file
            return predict_file(Model.load(args), fasta, engine="auto")
        import torch
        from augustus_tpu_torch.predict import Model, predict_file
        torch.set_num_threads(1)
        return predict_file(Model.load(args), fasta, device="cpu")
    if which.startswith("utr_") and which not in (
            "utr_tiled", "utr_sample_depth", "utr_pieces"):
        return utr_reference(which)
    if which in ("hs04636", "hints"):
        from augustus_tpu.predict import Model, predict_file
        args, fasta = (dict(ARGS), "HS04636.fa") if which == "hs04636" \
            else (hinted_args("HS04636sm.E.gff"), "HS04636sm.fa")
        return predict_file(Model.load(args), os.path.join(DATA, fasta),
                            engine="scan")
    import torch
    from augustus_tpu_torch.io.tiled import tiled_hinted, tiled_record
    from augustus_tpu_torch.predict import Model, predict_file, predict_records
    torch.set_num_threads(1)    # the plain versions are loops of small ops
    if which == "sample":
        return predict_file(Model.load(dict(SAMPLED)),
                            os.path.join(DATA, "HS04636.fa"), device="cpu")
    if which == "sample_hints":
        args = dict(hinted_args("HS04636sm.E.gff"), **FILTERS)
        args.update({k: SAMPLED[k] for k in
                     ("sample", "alternatives-from-sampling")})
        return predict_file(Model.load(args),
                            os.path.join(DATA, "HS04636sm.fa"), device="cpu")
    if which == "sample_depth":
        return predict_records(Model.load(dict(SAMPLED)), [depth_record()],
                               device="cpu")
    if which == "utr_sample_depth":
        return predict_records(Model.load(dict(UTR_SAMPLED)),
                               [depth_record()], device="cpu")
    if which.startswith("mea"):
        args, fasta = mea_run(which)
        if fasta is None:
            return predict_records(Model.load(dict(args)), [depth_record()],
                                   device="cpu")
        return predict_file(Model.load(dict(args)), fasta, device="cpu")
    if which in EVAL_SETS:
        from augustus_tpu_torch.predict import evaluate_genbank
        return evaluate_genbank(Model.load(dict(ARGS)),
                                os.path.join(DATA, EVAL_SETS[which]),
                                device="cpu")
    if which == "tiled":
        args, rec = dict(ARGS), tiled_record(DATA)
    elif which == "tiled_pieces":
        args, rec = dict(PIECES_ARGS), tiled_record(DATA)
    elif which == "utr_pieces":
        args, rec = dict(UTR_PIECES_ARGS), utr_pieces_record()
    elif which == "utr_tiled":
        args, rec = dict(UTR_ARGS), tiled_record(DATA)
    elif which == "tiled_sm":
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            args = hinted_args(exon_free_file(os.path.join(
                tmp, "tiled_sm.exon_free.gff")))
            return predict_records(Model.load(args), [tiled_hinted(DATA)[0]],
                                   device="cpu")
    else:
        args, rec = hinted_args("tiled_sm.E.gff"), tiled_hinted(DATA)[0]
    return predict_records(Model.load(args), [rec], device="cpu")


CGP_ARGS = dict(ARGS)
# the files of a cgp run (tests/torch_cgp_fixtures.py), each golden under
# augustus_tpu_torch/data/golden/ as cgp_<file>
CGP_SPECIES = ("hs", "mutB", "mutC")
CGP_FILES = tuple(f"{s}.cgp.gff" for s in CGP_SPECIES) + tuple(
    f"orthoExons.{s}.gff3" for s in CGP_SPECIES)


def cgp_texts(pkg: str, dst: str, store: str = "mem", device="cpu",
              loader: str = "functions") -> dict:
    """{file: text} of `pkg`'s CompGenePred.start on the seeded cgp input
    written into dst, its genomes read from memory ("mem") or from the
    SQLite store ("sqlite"), which `pkg`'s cgp.sqlite_db functions or its
    load2sqlitedb command line wrote (loader "functions" or "cli",
    torch_cgp_fixtures.load_store); the port decodes on `device`."""
    import importlib
    from torch_cgp_fixtures import write_cgp
    paths = write_cgp(os.path.join(dst, "input"), pkg, loader=loader)
    model = importlib.import_module(pkg + ".predict").Model.load(
        dict(CGP_ARGS))
    cgp = importlib.import_module(pkg + ".cgp").CompGenePred(
        model, paths["tree"], paths["aln"], paths["tbl"],
        outdir=os.path.join(dst, "out"),
        dbaccess=paths["db"] if store == "sqlite" else None)
    if pkg == "augustus_tpu":
        cgp.start()
    else:
        cgp.start(device)
    out = {}
    for f in CGP_FILES:
        with open(os.path.join(dst, "out", f)) as fh:
            out[f] = fh.read()
    return out


def omega_masked(text: str) -> str:
    """An orthoExons GFF3 with its MLomega and Eomega values masked.  Both
    packages estimate them (cgp/codonevo.py) from P(t) matrices whose
    entries into stop codons are eigendecomposition rounding noise (about
    1e-16, or 0 after the clip) that codon tuples with a stop codon read:
    the same on one host for both packages, not across LAPACK kernels
    (OPENBLAS_CORETYPE=Haswell on the goldens' host changes about half of
    the lines).  Every other field is kept."""
    import re
    return re.sub(r"(MLomega|Eomega)=[^;]*", r"\1=*", text)


def cgp_equal(name: str, text: str, want: str) -> bool:
    """A cgp output equal to its golden: a .cgp.gff byte for byte, an
    orthoExons GFF3 but for its omega values (omega_masked)."""
    if name.startswith("orthoExons."):
        return omega_masked(text) == omega_masked(want)
    return text == want


def write_cgp_goldens() -> None:
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        texts = cgp_texts("augustus_tpu", tmp)
    for name, text in texts.items():
        path = os.path.join(GOLDEN_DIR, "cgp_" + name)
        with open(path, "w") as fh:
            fh.write(text)
        print(f"{path}: {len(text)} characters")
    print(f"cgp: {time.perf_counter() - t0:.1f} s")


TRAIN_TARGETS = ("train_crf3", "train_utr")
PIPELINE_TARGETS = ("pipeline_hints", "chunks", "optimize", "ppx")


def write_pipeline_goldens(target: str) -> None:
    import tempfile
    import torch_pipeline as TP
    t0 = time.perf_counter()
    run = {"pipeline_hints": TP.pipeline_hints, "chunks": TP.chunks,
           "optimize": TP.optimize_phase, "ppx": TP.ppx}[target]
    with tempfile.TemporaryDirectory() as tmp:
        texts = run("augustus_tpu", tmp)
    for name, text in texts.items():
        print(f"{TP.write_golden(name, text)}: {len(text)} characters")
    print(f"{target}: {time.perf_counter() - t0:.1f} s")


def train_golden_texts(which: str, tmp: str) -> dict:
    """{golden file name: text} of the training set `which` ("crf3" or
    "utr", torch_training.TRAIN_SETS), computed with augustus_tpu in the
    configuration tmp."""
    from augustus_tpu.predict import Model, evaluate_genbank, predict_file
    from torch_training import (TRAIN_SETS, golden_name, make_config,
                                predict_args, species_files, train)
    queryfile, extra, suffixes = TRAIN_SETS[which]
    cfg = make_config(tmp, "augustus_tpu", "sp")
    files = species_files(train("augustus_tpu", cfg, "sp",
                                os.path.join(DATA, queryfile), **extra))
    out = {golden_name(which, s): files["sp" + s] for s in suffixes}
    model = Model.load(predict_args(cfg, "sp", which))
    out[golden_name(which, "_HS04636.gff")] = predict_file(
        model, os.path.join(DATA, "HS04636.fa"), engine="scan")
    if which == "crf3":
        out[golden_name(which, "_eval_test1.out")] = evaluate_genbank(
            model, os.path.join(DATA, "genes_test1.gb"), engine="scan")
    return out


def write_train_goldens(target: str) -> None:
    import gzip
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        texts = train_golden_texts(target[len("train_"):], tmp)
    for name, text in texts.items():
        path = os.path.join(GOLDEN_DIR, name)
        # mtime 0: the same text gives the same bytes
        with gzip.GzipFile(path, "wb", mtime=0) as fh:
            fh.write(text.encode())
        print(f"{path}: {len(text)} characters")
    print(f"{target}: {time.perf_counter() - t0:.1f} s")


def main(names) -> int:
    for which in names or sorted(GOLDENS) + list(TRAIN_TARGETS) + list(
            PIPELINE_TARGETS) + ["cgp"]:
        if which in TRAIN_TARGETS:
            write_train_goldens(which)
            continue
        if which in PIPELINE_TARGETS:
            write_pipeline_goldens(which)
            continue
        if which == "cgp":
            write_cgp_goldens()
            continue
        t0 = time.perf_counter()
        text = golden_gff(which)
        path = os.path.join(GOLDEN_DIR, GOLDENS[which])
        with open(path, "w") as fh:
            fh.write(text)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"{path}: {text.count(chr(9) + 'gene' + chr(9))} genes, "
              f"{time.perf_counter() - t0:.1f} s, peak RSS {rss} kB")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.exit(main(sys.argv[1:]))
