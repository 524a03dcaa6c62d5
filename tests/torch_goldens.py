"""Write the port's golden GFFs, made on the CPU.

    python3 tests/torch_goldens.py [hs04636] [tiled] [hints] [tiled_hints] \
        [sample] [sample_hints]

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
The tiled goldens do not come from `augustus_tpu`: the time per position
of its XLA scan on the CPU grows with the length, so 1 Mb takes hours.  The
port's CPU path equals `augustus_tpu` on every smaller input that
tests/test_torch_*.py hold them to; at 1 Mb it takes about 17 minutes on
one thread and 13 GB of memory, so run it where that is free.  Each golden
prints its seconds and the process's peak resident memory.
`chip_smoke.py` holds the card's output equal to all six goldens.
"""

import os
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

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
           "sample_hints": "repo_fixture_HS04636sm_hints_sample100.gff"}
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}
SAMPLED = dict(ARGS, sample="100")
SAMPLED["alternatives-from-sampling"] = "true"
# the posterior filters of the hinted sampled golden
FILTERS = {"minexonintronprob": "0.08", "minmeanexonintronprob": "0.4",
           "keep_viterbi": "true"}


def hinted_args(hints_file: str) -> dict:
    return dict(ARGS, softmasking="1",
                hintsfile=os.path.join(HINTS, hints_file),
                extrinsicCfgFile="extrinsic.M.RM.E.W.cfg")


def golden_gff(which: str) -> str:
    """The GFF text of one golden, computed anew."""
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
    if which == "tiled":
        args, rec = dict(ARGS), tiled_record(DATA)
    else:
        args, rec = hinted_args("tiled_sm.E.gff"), tiled_hinted(DATA)[0]
    return predict_records(Model.load(args), [rec], device="cpu")


def main(names) -> int:
    for which in names or sorted(GOLDENS):
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
    sys.exit(main(sys.argv[1:]))
