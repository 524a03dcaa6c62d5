"""Write the species ``repo_fixture_wide``: the template species ``generic``
(``make_train_fixture.py``) with ``/IntronModel/d 120`` in place of 100,
trained by the port's ``etraining`` on ``tests/data/genes_crf3.gb``.

The intron model's lessD window is ``d - 41`` bases wide
(``engine/gold.py``): 79 here, past the 64 that the forward kernel K3
(``csrc/forward.cu``) holds, so a sampled run with this species takes the
general kernels K2 and K5 (``predict._engine``, ``forward.k3_fits``).

Files written (under ``augustus_tpu_torch/data/config/species``):
``repo_fixture_wide/repo_fixture_wide_{parameters.cfg, exon_probs.pbl,
intron_probs.pbl, igenic_probs.pbl}``, byte for byte the same on every run.

Run from the repository root:
    python3 augustus_tpu_torch/data/make_wide_intron_fixture.py
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CONFIG = os.path.join(HERE, "config")
SPECIES = "repo_fixture_wide"
INTRON_D = 120
TRAIN_SET = os.path.join(ROOT, "tests", "data", "genes_crf3.gb")


def write(dst_config: str = CONFIG) -> str:
    """Train the species into a temporary configuration and copy it into
    dst_config/species; returns its directory there."""
    sys.path.insert(0, ROOT)
    from augustus_tpu_torch.training import etraining, new_species
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(CONFIG, "model"),
                        os.path.join(tmp, "model"))
        shutil.copytree(os.path.join(CONFIG, "species", "generic"),
                        os.path.join(tmp, "species", "generic"))
        new_species.create_species(SPECIES, tmp, silent=True)
        src = os.path.join(tmp, "species", SPECIES)
        cfg = os.path.join(src, f"{SPECIES}_parameters.cfg")
        with open(cfg) as fh:
            text = fh.read()
        text, n = re.subn(r"^(/IntronModel/d\s+)100$",
                          lambda m: m.group(1) + str(INTRON_D), text,
                          flags=re.M)
        assert n == 1, "generic sets /IntronModel/d once"
        with open(cfg, "w") as fh:
            fh.write(text)
        etraining.run_training({"species": SPECIES,
                                "AUGUSTUS_CONFIG_PATH": tmp,
                                "queryfile": TRAIN_SET}, device="cpu")
        dst = os.path.join(dst_config, "species", SPECIES)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
    return dst


if __name__ == "__main__":
    print(write())
