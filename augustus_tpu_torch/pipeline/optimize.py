"""Metaparameter optimization (optimize_augustus).

Reference: scripts/optimize_augustus.pl — for each metaparameter listed
in <species>_metapars.cfg (explicit list, integer range "a"-"b" or float
range "a"_"b"), try the candidate values with k-fold cross-validation on
the training GenBank set: train on k-1 buckets, predict + evaluate on
the held-out bucket, score by the reference's accuracy target (weighted
sens/spec over nucleotide/exon/gene levels) and keep the best value,
cycling through the parameters for --rounds rounds.

Port of `augustus_tpu/pipeline/optimize.py`, the same scores, chosen values
and stderr lines.  Each pass trains on the host (training/etraining.py;
--CRF=on predicts on the card too) and evaluates the held-out bucket on
`device` (predict.evaluate_genbank: every record on its route, the device
route running prefix.cu, the Viterbi kernel and the event walk).  `device`
takes the place of augustus_tpu's `engine=` argument: `cuda` unless the
caller asks for the CPU, and no fallback when the card is absent.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_metapars(path: str, max_values: int = 6
                   ) -> List[Tuple[str, List[str]]]:
    out = []
    for line in open(path):
        line = line.split("#")[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        name, spec = parts
        spec = spec.strip()
        m = re.match(r'^"([^"]+)"-"([^"]+)"$', spec)
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            step = max(1, (hi - lo) // (max_values - 1)) if hi > lo else 1
            vals = [str(v) for v in range(lo, hi + 1, step)]
        else:
            m = re.match(r'^"([^"]+)"_"([^"]+)"$', spec)
            if m:
                lo, hi = float(m.group(1)), float(m.group(2))
                vals = [f"{v:g}" for v in np.linspace(lo, hi, max_values)]
            else:
                vals = re.findall(r'"([^"]+)"', spec)
        if vals:
            out.append((name, vals))
    return out


def accuracy_target(output: str) -> float:
    """The reference's optimization target (optimize_augustus.pl
    gettarget): a weighted sum of sens/spec at nucleotide, exon and gene
    level, parsed from the evaluation table."""
    vals: Dict[str, Tuple[float, float]] = {}
    for line in output.splitlines():
        m = re.match(r"^(nucleotide|exon|gene) level \|.*\|\s*([0-9.]+)"
                     r"\s*\|\s*([0-9.]+)\s*\|", line)
        if m:
            vals[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    if not vals:
        return 0.0
    (ns, nsp) = vals.get("nucleotide", (0, 0))
    (es, esp) = vals.get("exon", (0, 0))
    (gs, gsp) = vals.get("gene", (0, 0))
    # optimize_augustus.pl: (3*nucSens + 3*nucSpec + 4*exonSens +
    # 4*exonSpec + 2*geneSens + 2*geneSpec) / 18
    return (3 * ns + 3 * nsp + 4 * es + 4 * esp + 2 * gs + 2 * gsp) / 18.0


def split_buckets(gb_path: str, k: int, workdir: str) -> List[str]:
    recs = []
    cur: List[str] = []
    for line in open(gb_path):
        cur.append(line)
        if line.startswith("//"):
            recs.append("".join(cur))
            cur = []
    paths = []
    for i in range(k):
        p = os.path.join(workdir, f"bucket{i}.gb")
        with open(p, "w") as fh:
            for j, r in enumerate(recs):
                if j % k == i:
                    fh.write(r)
        paths.append(p)
    return paths


def cv_score(species: str, config_path: str, buckets: List[str],
             overrides: Dict[str, str], workdir: str,
             device=None) -> float:
    """One cross-validation pass: train on k-1 buckets, evaluate on the
    held-out one on `device`; returns the mean accuracy target."""
    from ..predict import Model, evaluate_genbank, resolve_device
    from ..training.etraining import run_training
    device = resolve_device(device)
    scores = []
    for i in range(len(buckets)):
        train = [b for j, b in enumerate(buckets) if j != i]
        train_path = os.path.join(workdir, f"cv{i}.train.gb")
        with open(train_path, "w") as fh:
            for b in train:
                fh.write(open(b).read())
        args = {"species": species, "AUGUSTUS_CONFIG_PATH": config_path,
                "queryfile": train_path}
        args.update(overrides)
        run_training(args, device=device)
        margs = dict(args)
        margs["softmasking"] = "0"
        model = Model.load(margs)
        out = evaluate_genbank(model, buckets[i], device=device)
        scores.append(accuracy_target(out))
    return float(np.mean(scores))


def optimize(species: str, config_path: str, train_gb: str,
             metapars_path: Optional[str] = None, kfold: int = 8,
             rounds: int = 1, workdir: str = "optdir",
             device=None) -> Dict[str, str]:
    """Grid-search metaparameters (reference optimize_augustus.pl main
    loop); returns the chosen values (the reference also writes them into
    the species' _parameters.cfg; this port, like augustus_tpu, leaves
    that file alone)."""
    from ..predict import resolve_device
    device = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    if metapars_path is None:
        metapars_path = os.path.join(config_path, "species", "generic",
                                     "generic_metapars.cfg")
    pars = parse_metapars(metapars_path)
    buckets = split_buckets(train_gb, kfold, workdir)
    chosen: Dict[str, str] = {}
    for _ in range(rounds):
        for name, values in pars:
            best_v, best_s = None, -1.0
            for v in values:
                trial = dict(chosen)
                trial[name] = v
                s = cv_score(species, config_path, buckets, trial,
                             workdir, device)
                sys.stderr.write(f"# optimize: {name}={v} -> {s:.4f}\n")
                if s > best_s:
                    best_v, best_s = v, s
            chosen[name] = best_v
            sys.stderr.write(f"# optimize: chose {name}={best_v}\n")
    return chosen


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = {}
    pos = []
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            args[k] = v
        else:
            pos.append(a)
    if not pos or "species" not in args:
        sys.stderr.write(
            "usage: python -m augustus_tpu_torch.pipeline.optimize "
            "--species=SP --AUGUSTUS_CONFIG_PATH=... [--kfold=8] "
            "[--rounds=1] [--metapars=file] [--device=cpu|cuda] "
            "train.gb\n")
        return 1
    chosen = optimize(
        args["species"], args.get("AUGUSTUS_CONFIG_PATH", ""), pos[0],
        metapars_path=args.get("metapars"),
        kfold=int(args.get("kfold", "8")),
        rounds=int(args.get("rounds", "1")),
        workdir=args.get("workdir", "optdir"),
        device=args.get("device", "cuda"))
    for k, v in chosen.items():
        print(f"{k}\t{v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
