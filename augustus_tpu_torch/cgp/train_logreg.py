"""Logistic-regression training of CGP exon/intron feature weights.

Reference: src/train_logReg_param.cc — candidate exons/introns are
labeled by a reference annotation, features are standardized per
dimension ((x - mean)/se; the intercept stays raw), and the weights
minimize the cross-entropy error (the reference uses GSL conjugate
gradient; here full-batch gradient descent with the same loss and
standardization, vectorized in numpy).  Weights read/write the
`/CompPred/exon_scoreN` / `/CompPred/intron_scoreN` lines of the
`config/cgp/log_reg_parameters_*.cfg` files (train_logReg_param.cc:319
param_outfile).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def standardize(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]:
    """(X_std, mean, se); column 0 (intercept) is left raw
    (activation_f, train_logReg_param.cc:155)."""
    mean = X.mean(axis=0)
    se = X.std(axis=0)
    se = np.where(se > 0, se, 1.0)
    mean[0] = 0.0
    se[0] = 1.0
    return (X - mean) / se, mean, se


def train(samples: List[Tuple[int, List[float]]], iterations: int = 2000,
          lr: float = 0.1, rng: Optional[np.random.RandomState] = None
          ) -> Dict[str, np.ndarray]:
    """Cross-entropy logistic regression on labeled feature vectors.

    samples: (label in {0,1}, features) with features[0] == 1 (the
    intercept column, as the reference's feature 0).  Returns weights in
    the ORIGINAL feature space plus the standardization constants."""
    y = np.array([s[0] for s in samples], dtype=np.float64)
    X = np.array([s[1] for s in samples], dtype=np.float64)
    Xs, mean, se = standardize(X)
    n, d = Xs.shape
    w = np.zeros(d)
    for _ in range(iterations):
        z = Xs @ w
        sig = 1.0 / (1.0 + np.exp(-z))
        grad = Xs.T @ (sig - y) / n
        w -= lr * grad
    return {"weights": w, "mean": mean, "se": se}


def cross_entropy(samples, model) -> float:
    y = np.array([s[0] for s in samples], dtype=np.float64)
    X = np.array([s[1] for s in samples], dtype=np.float64)
    Xs = (X - model["mean"]) / model["se"]
    z = Xs @ model["weights"]
    sig = np.clip(1.0 / (1.0 + np.exp(-z)), 1e-12, 1 - 1e-12)
    return float(-(y * np.log(sig) + (1 - y) * np.log(1 - sig)).sum())


def predict_proba(features: np.ndarray, model) -> np.ndarray:
    Xs = (np.asarray(features, dtype=np.float64) - model["mean"]) \
        / model["se"]
    return 1.0 / (1.0 + np.exp(-(Xs @ model["weights"])))


def write_cfg(path: str, exon_model=None, intron_model=None,
              header: str = "# logistic regression scores trained by "
              "augustus_tpu cgp.train_logreg") -> None:
    """Write /CompPred/{exon,intron}_scoreN weight lines
    (log_reg_parameters_*.cfg format; weights are exported in the
    STANDARDIZED space the reference's activation uses, i.e. together
    with their mean/se lines as comments)."""
    with open(path, "w") as fh:
        fh.write(header + "\n\n")
        for tag, model in (("exon", exon_model), ("intron",
                                                  intron_model)):
            if model is None:
                continue
            w = model["weights"]
            for i, v in enumerate(w):
                fh.write(f"/CompPred/{tag}_score{i}\t{v:.8f}\n")
            fh.write(f"# {tag} feature mean: " +
                     " ".join(f"{m:g}" for m in model["mean"]) + "\n")
            fh.write(f"# {tag} feature se: " +
                     " ".join(f"{s:g}" for s in model["se"]) + "\n\n")


def read_cfg(path: str) -> Dict[str, Dict[int, float]]:
    """Parse /CompPred/exon_scoreN / intron_scoreN weights (reads both
    our output and the shipped config/cgp/log_reg_parameters_*.cfg)."""
    out: Dict[str, Dict[int, float]] = {"exon": {}, "intron": {}}
    pat = re.compile(r"/CompPred/(exon|intron)_score(\d+)\s+(\S+)")
    for line in open(path):
        line = line.split("#")[0]
        m = pat.search(line)
        if m:
            out[m.group(1)][int(m.group(2))] = float(m.group(3))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    feat = out = None
    for a in argv:
        if a.startswith("--trainFeatureFile="):
            feat = a.split("=", 1)[1]
        elif a.startswith("--param_outfile="):
            out = a.split("=", 1)[1]
    if feat is None or out is None:
        sys.stderr.write("usage: train_logreg --trainFeatureFile=f.tsv "
                         "--param_outfile=params.cfg\n"
                         "  f.tsv: kind(exon|intron) label f1 f2 ...\n")
        return 1
    buckets: Dict[str, List[Tuple[int, List[float]]]] = {"exon": [],
                                                         "intron": []}
    for line in open(feat):
        t = line.split()
        if len(t) < 3 or t[0] not in buckets:
            continue
        buckets[t[0]].append((int(t[1]),
                              [1.0] + [float(x) for x in t[2:]]))
    models = {}
    for kind, samp in buckets.items():
        if samp:
            models[kind] = train(samp)
            sys.stderr.write(
                f"# {kind}: {len(samp)} samples, CEE "
                f"{cross_entropy(samp, models[kind]):.3f}\n")
    write_cfg(out, exon_model=models.get("exon"),
              intron_model=models.get("intron"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
