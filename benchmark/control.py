"""The readings that set the limit of `gff_lines_differing`.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control]

For each seed, in one process: the cell set up and its window run as
benchmark/run.py runs them, then the windows of the check drawn and
decoded by the plain reference.  Each seed prints one JSON line with the
lower reading (the program against the reference) and, with --control,
the upper one: the reference computed with its Viterbi planes rounded to
bfloat16 (`reference.decode_window`, control "bf16"), put in the
program's place and judged against the reference.  The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import run as R  # noqa: E402


def readings(cell, done, control: bool) -> dict:
    from benchlib import correct
    fin, letters = R.finished(cell, done)
    wins, jobs = correct.window_jobs(fin, letters, cell.mix["check"],
                                     cell.seed, cell.config_path,
                                     cell.cfg["options"], cell.hints_path)
    t = time.perf_counter()
    ref = correct.run_reference(jobs, correct.workers())
    sound = correct.compare(fin, wins, None, ref)
    sound.update(correct.structure_check(fin, letters))
    out = {"seed": cell.seed, "records": len(fin),
           "reference_s": time.perf_counter() - t, "sound": sound}
    if control:
        low = [dict(j, control="bf16") for j in jobs]
        out["control"] = correct.compare(
            fin, wins, ref, correct.run_reference(low, correct.workers()))
    return out


def main(argv=None) -> int:
    R._paths()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = R.Cell(args.workload, seed, "cuda:0")
        try:
            done, _ = R.measure(cell, args.seconds, False)
            cell.free()
            line = readings(cell, done, args.control)
        finally:
            cell.close()
        line["failed"] = sum(1 for d in done if d.output is None)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
