"""The full-size test sequence: the repository's genomic sequences tiled
between seeded uniform-ACGT spacers.

`tiled_record(data_dir)` gives the >= 1,000,000-base sequence that
`chip_smoke.py` decodes on the card and whose prediction is committed as
`augustus_tpu_torch/data/golden/repo_fixture_tiled.gff`.  `data_dir` is the
repository's `tests/data`.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .fasta import FastaRecord, read_fasta

TILED_LENGTH = 1_000_000
TILED_SEED = 7
TILED_NAME = "tiled"


def genbank_sequences(path: str) -> List[str]:
    """The ORIGIN sequences of a GenBank file (letters only)."""
    seqs, cur = [], None
    with open(path) as fh:
        for line in fh:
            if line.startswith("ORIGIN"):
                cur = []
            elif line.startswith("//"):
                if cur is not None:
                    seqs.append("".join(cur))
                cur = None
            elif cur is not None:
                cur.append("".join(ch for ch in line if ch.isalpha()))
    return seqs


def tiled_record(data_dir: str) -> FastaRecord:
    """HS04636.fa, HS08198.fa and the sequences of genes_crf3.gb,
    genes_test1.gb and utrtrain.gb, in turn, each after a spacer of 2-20 kb
    drawn from numpy.random.default_rng(TILED_SEED), until the total reaches
    TILED_LENGTH."""
    parts = [r.sequence for f in ("HS04636.fa", "HS08198.fa")
             for r in read_fasta(os.path.join(data_dir, f))]
    for f in ("genes_crf3.gb", "genes_test1.gb", "utrtrain.gb"):
        parts += genbank_sequences(os.path.join(data_dir, f))
    rng = np.random.default_rng(TILED_SEED)
    acgt = np.frombuffer(b"acgt", dtype=np.uint8)
    out, total, i = [], 0, 0
    while total < TILED_LENGTH:
        spacer = acgt[rng.integers(0, 4, int(rng.integers(2000, 20001)))]
        out.append(spacer.tobytes().decode())
        out.append(parts[i % len(parts)].lower())
        total += len(out[-2]) + len(out[-1])
        i += 1
    return FastaRecord(TILED_NAME, "".join(out))
