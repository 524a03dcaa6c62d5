"""Write the training template: the species ``generic``, which
``training/new_species.py`` copies into a new species before
``cli/etraining.py`` trains it.

File written (under ``augustus_tpu_torch/data/config``):

* ``species/generic/generic_parameters.cfg``, in this order:

  - the constants of ``repo_fixture`` (its ``repo_fixture_parameters.cfg``
    without comments): table widths, motif lengths and the GC classes
    that a species trained on the template predicts with;
  - the UTR model's keys of ``repo_fixture_utr`` (the lines of
    ``repo_fixture_utr_parameters.cfg`` that ``repo_fixture``'s file does
    not have: ``/Constant/tss_upwindow_size`` and ``/UtrModel/*``, written
    by ``make_utr_fixture.py``);
  - the training state list ``/EHMMTraining/statecount 3`` with
    ``state00`` .. ``state02`` (exon, intron, intergenic model) and
    ``state03 utrmodel``, which ``--/EHMMTraining/statecount=4`` reaches
    (with ``--UTR=on``);
  - the four ``/…/outfile generic_*_probs.pbl`` keys (``new_species``
    puts the species' name in place of ``generic``);
  - the remaining training keys (``TRAIN_KEYS``): where
    ``repo_fixture``'s ``.pbl`` files (``tests/data/train_golden``) record
    the value they were trained with, that value; else the default that
    the trainer reads (``training/models.py``).

Run from the repository root:  python3 augustus_tpu_torch/data/make_train_fixture.py
"""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
SPECIES = os.path.join(HERE, "config", "species")
DST = os.path.join(SPECIES, "generic")

STATES = ("exonmodel", "intronmodel", "igenicmodel", "utrmodel")
STATECOUNT = 3          # without --/EHMMTraining/statecount=4 no UTR model
OUTFILES = (("/ExonModel/outfile", "generic_exon_probs.pbl"),
            ("/IntronModel/outfile", "generic_intron_probs.pbl"),
            ("/IGenicModel/outfile", "generic_igenic_probs.pbl"),
            ("/UtrModel/outfile", "generic_utr_probs.pbl"))

# (comment, ((key, value), ...)): the values repo_fixture's .pbl headers
# record, then the trainers' defaults
TRAIN_KEYS = (
    ("recorded by repo_fixture_exon_probs.pbl ([LENGTH], [TRANSINIT], "
     "[ETMOTIF0], [EMISSION])",
     (("/ExonModel/exonlengthD", "2000"),
      ("/ExonModel/slope_of_bandwidth", "0.3"),
      ("/ExonModel/minwindowcount", "10"),
      ("/ExonModel/tis_motif_memory", "3"),
      ("/ExonModel/etorder", "2"),
      ("/ExonModel/patpseudocount", "5"))),
    ("recorded by repo_fixture_intron_probs.pbl ([ASS], [DSS], [LENGTH], "
     "[EMISSION], [ASSMOTIF])",
     (("/IntronModel/k", "4"),
      ("/IntronModel/asspseudocount", "0.00266"),
      ("/IntronModel/dsspseudocount", "0.0005"),
      ("/IntronModel/d", "100"),
      ("/IntronModel/patpseudocount", "5"),
      ("/IntronModel/ass_motif_memory", "3"))),
    ("recorded by repo_fixture_igenic_probs.pbl (k)",
     (("/IGenicModel/k", "4"),)),
    ("not recorded: the defaults of training/models.py",
     (("/ExonModel/minPatSum", "0"),
      ("/ExonModel/etpseudocount", "3"),
      ("/ExonModel/tis_motif_radius", "2"),
      ("/IntronModel/slope_of_bandwidth", "0.1"),
      ("/IntronModel/minwindowcount", "0"),
      ("/IntronModel/dssneighborfactor", "0.01"),
      ("/IntronModel/ass_motif_radius", "3"),
      ("/IGenicModel/patpseudocount", "1"))),
)


def _keys(path: str) -> list:
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if ln and not ln.startswith("#")]


def _line(key: str, value: str) -> str:
    return f"{key:<31} {value}"


def parameters() -> str:
    base = _keys(os.path.join(SPECIES, "repo_fixture",
                              "repo_fixture_parameters.cfg"))
    utr = [ln for ln in _keys(os.path.join(
        SPECIES, "repo_fixture_utr", "repo_fixture_utr_parameters.cfg"))
        if ln not in base]
    out = ["# Parameters of the species generic. "
           "use as template for your own species",
           "# Written by augustus_tpu_torch/data/make_train_fixture.py.",
           "# The constants of repo_fixture:"]
    out += base
    out += ["# The UTR model's keys of repo_fixture_utr:"]
    out += utr
    out += ["# Training: the models in training order (state03 with "
            "--/EHMMTraining/statecount=4)",
            _line("/EHMMTraining/statecount", str(STATECOUNT))]
    out += [_line(f"/EHMMTraining/state{i:02d}", s)
            for i, s in enumerate(STATES)]
    out += ["# The parameter files that training writes:"]
    out += [_line(k, v) for k, v in OUTFILES]
    for comment, keys in TRAIN_KEYS:
        out.append("# " + comment + ":")
        out += [_line(k, v) for k, v in keys]
    return "\n".join(out) + "\n"


def main() -> None:
    os.makedirs(DST, exist_ok=True)
    with open(os.path.join(DST, "generic_parameters.cfg"), "w") as fh:
        fh.write(parameters())


if __name__ == "__main__":
    main()
