"""Write the hint files of the softmasked, EST-hinted fixtures.

    python3 augustus_tpu_torch/data/make_hints_fixture.py

Writes, under augustus_tpu_torch/data/hints/:
  HS04636sm.E.gff  EST-style hints (src=E) of the HS04636 gene of
                   tests/data/golden_human_mpe_hints.gff (g1, CDS 966-7633)
                   for tests/data/HS04636sm.fa
  HS04636rc.E.gff  the same hints mirrored onto tests/data/HS04636rc.fa
                   (the reverse complement: minus-strand hints)
  tiled_sm.E.gff   the hints of augustus_tpu_torch/io/tiled.py:tiled_hinted
                   (every gene inserted into the 1,023,095-base sequence)
The hints of one gene come from io/tiled.py:gene_hints; off-structure hints
from numpy.random.default_rng(7), so the files are the same on every run.
Use them with the extrinsic config
augustus_tpu_torch/data/config/extrinsic/extrinsic.M.RM.E.W.cfg.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(ROOT, "tests", "data")
HINTS = os.path.join(HERE, "hints")
SEED = 7
HS04636_LEN = 9453


def hint_files():
    """{file name: GFF text} of every hint file of the fixture."""
    from augustus_tpu_torch.io.tiled import (
        gene_hints, golden_cds, mirror_hints, tiled_hinted)
    exons = golden_cds(os.path.join(DATA, "golden_human_mpe_hints.gff"),
                       "HS04636")
    sm = gene_hints(exons, "+", "HS04636sm", "g1", HS04636_LEN,
                    np.random.default_rng(SEED), with_signals=True)
    rc = mirror_hints(sm, "HS04636rc", HS04636_LEN)
    return {"HS04636sm.E.gff": "".join(sm),
            "HS04636rc.E.gff": "".join(rc),
            "tiled_sm.E.gff": "".join(tiled_hinted(DATA)[1])}


def main() -> int:
    os.makedirs(HINTS, exist_ok=True)
    for name, text in hint_files().items():
        with open(os.path.join(HINTS, name), "w") as fh:
            fh.write(text)
        print(f"{name}: {text.count(chr(10))} hints")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
