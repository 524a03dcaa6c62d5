"""Training runs of both packages on the CPU, each into a temporary
configuration made from the template species ``generic``
(augustus_tpu_torch/data/make_train_fixture.py): the tests of
augustus_tpu_torch/training and the training goldens of torch_goldens.py.

A configuration is the ``model/`` directory of the port's fixture config
and ``species/generic``; ``new_species`` of the package makes the species
from it, ``run_training`` of the package trains it (the port on the CPU).
"""

import gzip
import importlib
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN_DIR = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
PKGS = ("augustus_tpu", "augustus_tpu_torch")
# the 5,612-base third record of genes_crf3.gb, held out of genes_test1.gb
# (its first record)
HELD_OUT = "chr2L_115837-121448"
UTR_TRAIN = {"UTR": "on", "/EHMMTraining/statecount": "4"}
MODELS = ("exon", "intron", "igenic")
# the training goldens: (GenBank set, arguments, files of the species by
# suffix); the CRF files are the CRF-trained ones and the .HMM copies the
# maximum-likelihood ones that CRF training keeps
TRAIN_SETS = {
    "crf3": ("genes_crf3.gb", {"CRF": "on"},
             [f"_{m}_probs.pbl" for m in MODELS]
             + [f"_{m}_probs.pbl.HMM" for m in ("exon", "intron")]),
    "utr": ("utrtrain.gb", UTR_TRAIN,
            [f"_{m}_probs.pbl" for m in MODELS + ("utr",)]),
}


def make_config(dst: str, pkg: str, species: str) -> str:
    """dst/model and dst/species/generic from the port's fixture config,
    then `pkg`'s create_species(species); returns dst."""
    shutil.copytree(os.path.join(CONFIG, "model"),
                    os.path.join(dst, "model"))
    shutil.copytree(os.path.join(CONFIG, "species", "generic"),
                    os.path.join(dst, "species", "generic"))
    new_species = importlib.import_module(pkg + ".training.new_species")
    new_species.create_species(species, dst, silent=True)
    return dst


def train_args(cfg: str, species: str, queryfile: str, **extra) -> dict:
    return dict({"species": species, "AUGUSTUS_CONFIG_PATH": cfg,
                 "queryfile": queryfile}, **extra)


def train(pkg: str, cfg: str, species: str, queryfile: str, **extra) -> str:
    """`pkg`'s run_training (the port's on the CPU); returns the species
    directory."""
    etraining = importlib.import_module(pkg + ".training.etraining")
    args = train_args(cfg, species, queryfile, **extra)
    if pkg == "augustus_tpu":
        etraining.run_training(args)
    else:
        etraining.run_training(args, device="cpu")
    return os.path.join(cfg, "species", species)


def species_files(species_dir: str) -> dict:
    """{file name: text} of a species directory."""
    out = {}
    for f in sorted(os.listdir(species_dir)):
        with open(os.path.join(species_dir, f)) as fh:
            out[f] = fh.read()
    return out


def held_out_gb(dst_dir: str) -> str:
    """A GenBank file holding the held-out record of genes_crf3.gb alone."""
    with open(os.path.join(DATA, "genes_crf3.gb")) as fh:
        text = fh.read()
    start = text.index("LOCUS       " + HELD_OUT)
    end = text.index("//\n", start) + 3
    path = os.path.join(dst_dir, "held_out.gb")
    with open(path, "w") as fh:
        fh.write(text[start:end])
    return path


def golden_name(which: str, suffix: str) -> str:
    """The golden of one file of a trained species (gzipped)."""
    return f"train_{which}{suffix}.gz"


def read_golden(name: str) -> str:
    path = os.path.join(GOLDEN_DIR, name)
    if name.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            return fh.read()
    with open(path) as fh:
        return fh.read()


def species_from_goldens(dst: str, pkg: str, which: str,
                         species: str) -> str:
    """A configuration whose species holds the golden files of the
    training set `which` (TRAIN_SETS); returns dst."""
    make_config(dst, pkg, species)
    for suffix in TRAIN_SETS[which][2]:
        if suffix.endswith(".HMM"):
            continue
        with open(os.path.join(dst, "species", species, species + suffix),
                  "w") as fh:
            fh.write(read_golden(golden_name(which, suffix)))
    return dst


def predict_args(cfg: str, species: str, which: str) -> dict:
    """The arguments with which a species trained on `which` predicts."""
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": cfg,
            "UTR": "off", "softmasking": "0"}
    if which == "utr":
        args.update(UTR="on", print_utr="on")
    return args


def pbl_blocks(text: str) -> dict:
    """{block name: lines} of a .pbl text (a block from its '[NAME]' line to
    the next; 'header' before the first; a repeated name gets '#2')."""
    out, name, cur = {}, "header", []
    for line in text.splitlines():
        if line.startswith("[") and "]" in line:
            out[name] = cur
            name = line[1:line.index("]")]
            if name in out:
                name += "#2"
            cur = []
        cur.append(line)
    out[name] = cur
    return out


def utr_blocks_against_augustus() -> dict:
    """{block: equal?} of the --UTR=on golden (train_utr_utr_probs.pbl,
    utrtrain.gb with the template's keys) against the file that AUGUSTUS
    3.5.0's etraining wrote from the same set with its generic template
    (tests/data/train_golden/utr_probs.pbl.gz).  A record, not a gate: the
    template's /UtrModel/* keys are repo_fixture_utr's."""
    ours = pbl_blocks(read_golden(golden_name("utr", "_utr_probs.pbl")))
    with gzip.open(os.path.join(DATA, "train_golden", "utr_probs.pbl.gz"),
                   "rt") as fh:
        ref = pbl_blocks(fh.read())
    return {k: ours.get(k) == v for k, v in ref.items()}


if __name__ == "__main__":
    # python3 tests/torch_training.py: the record of utr_blocks_against_augustus
    for block, equal in utr_blocks_against_augustus().items():
        print(f"{block}: {'equal' if equal else 'differs'}")
