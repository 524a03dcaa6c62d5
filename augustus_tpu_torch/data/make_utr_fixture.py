"""Write the UTR fixture: the 71-state architecture and the species
``repo_fixture_utr``.

Files written (under ``augustus_tpu_torch/data/config``):

* ``model/states_shadow_utr.cfg``: states 0-46 as in ``states_shadow.cfg``
  (same indices, so the coding transitions carry over), then the 24 UTR
  states 47-70 (``UTR_STATES`` below, in the order of their
  ``/UtrModel/typeNN`` identifiers).
* ``model/trans_shadow_partial_utr.pbl``: the 47-state transitions of
  ``trans_shadow_partial.pbl`` without the direct igenic <-> coding exon
  edges, plus the UTR topology of ``_utr_transitions``: every complete gene
  runs igenic -> 5' UTR -> coding exons -> 3' UTR -> igenic on the forward
  strand, and igenic -> reverse 3' UTR -> reverse coding exons -> reverse 5'
  UTR -> igenic on the reverse strand.  The four igenic exits are 1e-4
  each (the 47-state file has eight of 1e-5; with 5e-5 each no complete
  gene is predicted on ``tests/data/HS04636.fa``, whose annotated mRNA in
  ``tests/data/utrtrain.gb`` the 1e-4 run finds with its TSS and stop
  codon); UTR introns are per-base chains with the coding geometric
  introns' self loop of 0.99.  The coding geometric introns' initial and
  terminal probabilities are 1e-4, so that a gene the sequence does not
  cut ends in its UTRs rather than in a coding intron at the sequence
  end.  The ``intronvar`` states, which only hints reach, get no incoming
  edge.
* ``species/repo_fixture_utr/``: ``repo_fixture``'s three ``*_probs.pbl``
  (renamed), a parameters file with ``repo_fixture``'s constants and the
  ``/UtrModel/*`` keys (``UTR_KEYS``: the values that reproduce the TSS, TATA
  and TTS blocks of ``tests/data/train_golden/utr_probs.pbl.gz`` from
  ``tests/data/utrtrain.gb``, and pattern weights of 0.1, strictly between
  0 and 1 so that the UTR content tables count: they are trained on two
  genes, and at 0.5 or 0.9 no gene is predicted on ``HS04636.fa``), and
  ``repo_fixture_utr_utr_probs.pbl``: that golden file with its emission,
  TSS, TATA and TTS blocks byte for byte and only the ``[UTRLENGTH]``
  block rewritten.

The rewritten length block gives each of the 8 UTR exon types (5' single,
initial, internal, terminal; 3' the same) a gamma(2) length distribution of
scale m (``LENGTH_SCALE``), stored for k = 0..800 in per mille:

    1000 * P(len = k) = 1000 * k * exp(-k / m) / m**2      (P(len = 0) = 0)

printed with 6 significant digits, with ``NUM_EXONS`` exons counted per
type and ``num_huge = max(round(a * (NUM_EXONS + 1) / (1 - q)) - 1, 0)``
of them longer than 800, where a = P(len = 800) as printed and
q = (801 / 800) * exp(-1 / m), so that the reader's geometric tail
(``model/pbl._fill_length_tail``: P(k) = p * P(k - 1), p = 1 - a * (num + 1)
/ (num_huge + 1)) continues the gamma's decay out to ``maxexonlength``
(1,500) and ``max3singlelength`` (5,500); where P(800) is too small for
that (num_huge 0) the tail decays more slowly from a negligible P(800).

Run from the repository root:  python3 augustus_tpu_torch/data/make_utr_fixture.py
"""

from __future__ import annotations

import gzip
import math
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
MODEL = os.path.join(HERE, "config", "model")
SRC = os.path.join(HERE, "config", "species", "repo_fixture")
DST = os.path.join(HERE, "config", "species", "repo_fixture_utr")
GOLDEN_UTR = os.path.join(REPO, "tests", "data", "train_golden",
                          "utr_probs.pbl.gz")

UTR_STATES = (
    "utr5single", "utr5init", "utr5intron", "utr5intronvar", "utr5internal",
    "utr5term", "utr3single", "utr3init", "utr3intron", "utr3intronvar",
    "utr3internal", "utr3term",
    "rutr5single", "rutr5init", "rutr5intron", "rutr5intronvar",
    "rutr5internal", "rutr5term", "rutr3single", "rutr3init", "rutr3intron",
    "rutr3intronvar", "rutr3internal", "rutr3term")
U = {name: 47 + i for i, name in enumerate(UTR_STATES)}

# 47-state indices (trans_shadow_partial.pbl's header)
IGENIC, SINGLE, TERMINAL = 0, 1, 8
INITIAL = (2, 3, 4)
RSINGLE, RINITIAL = 24, 25
RTERMINAL = (29, 30, 31)
CODING_ENTRY = (SINGLE,) + INITIAL
RCODING_ENTRY = (RSINGLE,) + RTERMINAL


def _utr_transitions():
    """(from, to, probability, comment) of the UTR topology."""
    t = []

    def add(comment, *edges):
        for i, (a, b, p) in enumerate(edges):
            t.append((a, b, p, comment if i == 0 else None))

    add("intergenic region: self loop and the four UTR entries",
        (IGENIC, IGENIC, 0.9996),
        (IGENIC, U["utr5single"], 0.0001), (IGENIC, U["utr5init"], 0.0001),
        (IGENIC, U["rutr3single"], 0.0001), (IGENIC, U["rutr3term"], 0.0001))
    for strand, r in (("forward", ""), ("reverse", "r")):
        intron5, intron3 = U[r + "utr5intron"], U[r + "utr3intron"]
        add(f"{strand} UTR introns: per-base chains",
            (intron5, intron5, 0.99), (intron3, intron3, 0.99))
    add("forward 5' UTR: tss -> single | init -> intron -> internal* -> term"
        " -> start codon",
        *[(U["utr5single"], c, 0.25) for c in CODING_ENTRY],
        (U["utr5init"], U["utr5intron"], 1.0),
        (U["utr5intron"], U["utr5internal"], 0.003),
        (U["utr5intron"], U["utr5term"], 0.007),
        (U["utr5intronvar"], U["utr5internal"], 0.3),
        (U["utr5intronvar"], U["utr5term"], 0.7),
        (U["utr5internal"], U["utr5intron"], 1.0),
        *[(U["utr5term"], c, 0.25) for c in CODING_ENTRY])
    add("forward coding exons that end the CDS lead into the 3' UTR",
        (SINGLE, U["utr3single"], 0.5), (SINGLE, U["utr3init"], 0.5),
        (TERMINAL, U["utr3single"], 0.5), (TERMINAL, U["utr3init"], 0.5))
    add("forward 3' UTR: single | init -> intron -> internal* -> term -> tts",
        (U["utr3single"], IGENIC, 1.0),
        (U["utr3init"], U["utr3intron"], 1.0),
        (U["utr3intron"], U["utr3internal"], 0.003),
        (U["utr3intron"], U["utr3term"], 0.007),
        (U["utr3intronvar"], U["utr3internal"], 0.3),
        (U["utr3intronvar"], U["utr3term"], 0.7),
        (U["utr3internal"], U["utr3intron"], 1.0),
        (U["utr3term"], IGENIC, 1.0))
    add("reverse 3' UTR (left of the CDS): tts -> single | term -> intron ->"
        " internal* -> init -> stop codon",
        *[(U["rutr3single"], c, 0.25) for c in RCODING_ENTRY],
        (U["rutr3term"], U["rutr3intron"], 1.0),
        (U["rutr3intron"], U["rutr3internal"], 0.003),
        (U["rutr3intron"], U["rutr3init"], 0.007),
        (U["rutr3intronvar"], U["rutr3internal"], 0.3),
        (U["rutr3intronvar"], U["rutr3init"], 0.7),
        (U["rutr3internal"], U["rutr3intron"], 1.0),
        *[(U["rutr3init"], c, 0.25) for c in RCODING_ENTRY])
    add("reverse coding exons that hold the start codon lead into the 5' UTR",
        (RSINGLE, U["rutr5single"], 0.5), (RSINGLE, U["rutr5term"], 0.5),
        (RINITIAL, U["rutr5single"], 0.5), (RINITIAL, U["rutr5term"], 0.5))
    add("reverse 5' UTR: term -> intron -> internal* -> init -> tss | single",
        (U["rutr5single"], IGENIC, 1.0),
        (U["rutr5term"], U["rutr5intron"], 1.0),
        (U["rutr5intron"], U["rutr5internal"], 0.003),
        (U["rutr5intron"], U["rutr5init"], 0.007),
        (U["rutr5intronvar"], U["rutr5internal"], 0.3),
        (U["rutr5intronvar"], U["rutr5init"], 0.7),
        (U["rutr5internal"], U["rutr5intron"], 1.0),
        (U["rutr5init"], IGENIC, 1.0))
    return t


# initial / terminal probabilities: igenic, the six coding geometric introns
# of trans_shadow_partial.pbl and the four UTR introns (partial genes)
CODING_GEOMETRIC = (12, 17, 22, 35, 40, 45)
UTR_INTRONS = tuple(U[s] for s in ("utr5intron", "utr3intron",
                                   "rutr5intron", "rutr3intron"))
INITIAL_PROBS = ([(IGENIC, 0.9744)] + [(s, 0.0001) for s in CODING_GEOMETRIC]
                 + [(s, 0.00625) for s in UTR_INTRONS])
TERMINAL_PROBS = ([(IGENIC, 1)] + [(s, 0.0001) for s in CODING_GEOMETRIC]
                  + [(s, 1) for s in UTR_INTRONS])

UTR_KEYS = (
    ("/Constant/tss_upwindow_size", "45"),
    ("/UtrModel/k", "4"),
    ("/UtrModel/patpseudocount", "1"),
    ("/UtrModel/tssup_k", "0"),
    ("/UtrModel/tssup_patpseudocount", "1"),
    ("/UtrModel/exonlengthD", "800"),
    ("/UtrModel/maxexonlength", "1500"),
    ("/UtrModel/max3singlelength", "5500"),
    ("/UtrModel/max3termlength", "3500"),
    ("/UtrModel/slope_of_bandwidth", "0.2375"),
    ("/UtrModel/minwindowcount", "3"),
    ("/UtrModel/tss_start", "8"),
    ("/UtrModel/tss_end", "5"),
    ("/UtrModel/tata_start", "2"),
    ("/UtrModel/tata_end", "10"),
    ("/UtrModel/tata_pseudocount", "1"),
    ("/UtrModel/d_tss_tata_min", "26"),
    ("/UtrModel/d_tss_tata_max", "37"),
    ("/UtrModel/d_polyasig_cleavage", "14"),
    ("/UtrModel/d_polya_cleavage_min", "10"),
    ("/UtrModel/d_polya_cleavage_max", "35"),
    ("/UtrModel/tts_motif_memory", "1"),
    ("/UtrModel/polyasig_consensus", "aataaa"),
    ("/UtrModel/prob_polya", "0.9"),
    ("/UtrModel/utr5patternweight", "0.1"),
    ("/UtrModel/utr3patternweight", "0.1"),
)

# gamma(2) scale per column: 5' single, initial, internal, terminal; 3' the
# same (mean length 2 m)
LENGTH_SCALE = (60.0, 50.0, 40.0, 50.0, 250.0, 60.0, 60.0, 200.0)
NUM_EXONS = 100000
LEN_D = 800


def states_cfg() -> str:
    with open(os.path.join(MODEL, "states_shadow.cfg")) as fh:
        lines = fh.read().splitlines()
    out = ["# State architecture: forward and reverse (shadow) strand with UTRs.",
           "# States 0-46 as in states_shadow.cfg, UTR states 47-70 (24).",
           "# Written by augustus_tpu_torch/data/make_utr_fixture.py."]
    for line in lines:
        if line.startswith("#"):
            continue
        if line.startswith("/NAMGene/statecount"):
            out.append("/NAMGene/statecount 71")
        else:
            out.append(line)
        if line.startswith("/NAMGene/state46"):
            out += [f"/NAMGene/state{s} utrmodel" for s in range(47, 71)]
    out += [f"/UtrModel/type{i:02d} {name}"
            for i, name in enumerate(UTR_STATES)]
    return "\n".join(out) + "\n"


def trans_pbl() -> str:
    with open(os.path.join(MODEL, "trans_shadow_partial.pbl")) as fh:
        text = fh.read()
    body = text.split("[Transition]", 1)[1]
    coding = []
    for line in body.splitlines():
        f = line.split("#", 1)[0].split()
        if len(f) != 3:
            if line.startswith("# ") and "from to" not in line \
                    and "intergenic" not in line:
                coding.append(line)
            continue
        a, b = int(f[0]), int(f[1])
        if IGENIC in (a, b):
            continue        # igenic <-> coding edges go through the UTRs
        coding.append(line)
    numbering = "\n".join(
        f"#   {47 + 6 * k}-{52 + 6 * k} "
        + " ".join(UTR_STATES[6 * k: 6 * k + 6]) for k in range(4))
    out = [
        "# Transition, initial and terminal probabilities of the 71-state",
        "# shadow architecture with UTRs and partial genes (states as in",
        "# states_shadow_utr.cfg).  Written by",
        "# augustus_tpu_torch/data/make_utr_fixture.py from",
        "# trans_shadow_partial.pbl.",
        "#",
        "# state numbers:",
        "#   0-46 as in trans_shadow_partial.pbl: 0 igenic | 1 single,",
        "#   2-4 initial0-2, 5-7 internal0-2, 8 terminal | 9-23 forward introns",
        "#   | 24 rsingle, 25 rinitial, 26-28 rinternal0-2, 29-31 rterminal0-2",
        "#   | 32-46 reverse introns",
        numbering,
        "# The igenic <-> coding exon edges of the 47-state file are replaced",
        "# by the UTRs: igenic -> 5' UTR -> start codon ... stop codon -> 3' UTR",
        "# -> igenic on the forward strand, the mirror image on the reverse",
        "# strand.  The intronvar states (50, 56, 62, 68) are reached only",
        "# through intron hints and get no incoming edge.",
        "",
        "[Initial]",
        "# number of states",
        "71",
        "# initial probabilities",
    ]
    out += [f"{s:<4} {p:g}" for s, p in INITIAL_PROBS]
    out += ["", "[Terminal]", "# number of states", "71"]
    out += [f"{s:<4} {p:g}" for s, p in TERMINAL_PROBS]
    out += ["", "[Transition]", "# from to probability"]
    for a, b, p, comment in _utr_transitions():
        if comment:
            out.append("# " + comment)
        out.append(f"{a:<4} {b:<4} {p:g}")
    out += coding
    return "\n".join(out) + "\n"


def length_block() -> str:
    """The [UTRLENGTH] block of the module docstring."""
    cols = []
    for m in LENGTH_SCALE:
        cols.append(["%.6g" % (1000.0 * k * math.exp(-k / m) / (m * m))
                     for k in range(LEN_D + 1)])
    huge = []
    for m, col in zip(LENGTH_SCALE, cols):
        a = float(col[LEN_D]) / 1000.0
        q = (LEN_D + 1) / LEN_D * math.exp(-1.0 / m)
        huge.append(max(int(round(a * (NUM_EXONS + 1) / (1.0 - q))) - 1, 0))
    lines = [
        "[UTRLENGTH]",
        "# maximal individually stored length probability d=",
        str(LEN_D),
        "# slope of smoothing bandwidth =",
        "0.2375",
        "# smoothing minwindowcount =",
        "3",
        "# length 5' sing  5' init  5' int  5' term  3' sing  3' init  3' int"
        "  3' term ",
        "# total number of exons of above types",
        "".join("%10d" % NUM_EXONS for _ in cols),
        f"# number of exons exceeding length d={LEN_D}",
        "".join("%10d" % h for h in huge),
        f"# 1000 P(len=k), k=0,1,..., {LEN_D}",
    ]
    for k in range(LEN_D + 1):
        lines.append(str(k) + "".join("\t" + c[k] for c in cols))
    return "\n".join(lines) + "\n"


def utr_pbl() -> str:
    with gzip.open(GOLDEN_UTR, "rt") as fh:
        text = fh.read()
    head, rest = text.split("[UTRLENGTH]\n", 1)
    tail = rest[rest.index("#\n# AATAAA"):]
    return head + length_block() + tail


def parameters() -> str:
    with open(os.path.join(SRC, "repo_fixture_parameters.cfg")) as fh:
        base = [ln for ln in fh.read().splitlines()
                if ln and not ln.startswith("#")]
    out = ['# Species parameters of the UTR fixture "repo_fixture_utr".',
           "# Written by augustus_tpu_torch/data/make_utr_fixture.py: the",
           "# constants of repo_fixture, then the UTR model's keys (the values",
           "# the TSS/TATA/TTS blocks of its _utr_probs.pbl were trained with,",
           "# pattern weights 0.1)."]
    out += base
    out += [f"{k:<31} {v}" for k, v in UTR_KEYS]
    return "\n".join(out) + "\n"


def main() -> None:
    with open(os.path.join(MODEL, "states_shadow_utr.cfg"), "w") as fh:
        fh.write(states_cfg())
    with open(os.path.join(MODEL, "trans_shadow_partial_utr.pbl"), "w") as fh:
        fh.write(trans_pbl())
    os.makedirs(DST, exist_ok=True)
    for model in ("igenic", "exon", "intron"):
        shutil.copyfile(
            os.path.join(SRC, f"repo_fixture_{model}_probs.pbl"),
            os.path.join(DST, f"repo_fixture_utr_{model}_probs.pbl"))
    with open(os.path.join(DST, "repo_fixture_utr_parameters.cfg"), "w") as fh:
        fh.write(parameters())
    with open(os.path.join(DST, "repo_fixture_utr_utr_probs.pbl"), "w") as fh:
        fh.write(utr_pbl())


if __name__ == "__main__":
    main()
