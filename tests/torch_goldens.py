"""Write the port's golden GFFs, made on the CPU.

    python3 tests/torch_goldens.py [hs04636] [tiled]

Both use the `repo_fixture` species with `--UTR=off --softmasking=0`:
  hs04636  tests/data/HS04636.fa through `augustus_tpu` predict_file
           (engine="scan", JAX on the CPU)
           -> augustus_tpu_torch/data/golden/repo_fixture_HS04636.gff
  tiled    the 1,023,095-base sequence of augustus_tpu_torch/io/tiled.py
           through the port's own CPU path, predict_records(device="cpu"),
           where the plain PyTorch version of each kernel runs
           -> augustus_tpu_torch/data/golden/repo_fixture_tiled.gff
The tiled golden does not come from `augustus_tpu`: the time per position
of its XLA scan on the CPU grows with the length, so 1 Mb takes hours.  The
port's CPU path equals `augustus_tpu` on every smaller input that
tests/test_torch_*.py hold them to; at 1 Mb it takes about 17 minutes on
one thread and 13 GB of memory, so run it where that is free.  Each golden
prints its seconds and the process's peak resident memory.
`chip_smoke.py` holds the card's output equal to both goldens.
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
GOLDENS = {"hs04636": "repo_fixture_HS04636.gff",
           "tiled": "repo_fixture_tiled.gff"}
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}


def golden_gff(which: str) -> str:
    """The GFF text of one golden, computed anew."""
    if which == "hs04636":
        from augustus_tpu.predict import Model, predict_file
        return predict_file(Model.load(dict(ARGS)),
                            os.path.join(DATA, "HS04636.fa"), engine="scan")
    import torch
    from augustus_tpu_torch.io.tiled import tiled_record
    from augustus_tpu_torch.predict import Model, predict_records
    torch.set_num_threads(1)    # the plain versions are loops of small ops
    return predict_records(Model.load(dict(ARGS)), [tiled_record(DATA)],
                           device="cpu")


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
