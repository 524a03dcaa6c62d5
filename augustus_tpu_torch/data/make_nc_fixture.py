"""Write the ncRNA fixture: the 83-state architecture of ``--nc=on``.

Files written (under ``augustus_tpu_torch/data/config/model``):

* ``states_shadow_utr_nc.cfg``: ``states_shadow_utr.cfg`` (states 0-70 at
  their indices, so that the UTR transitions carry over), then the 12 nc
  states 71-82 of class ``ncmodel`` (``NC_STATES`` below, in the order of
  their ``/NcModel/typeNN`` identifiers).
* ``trans_shadow_partial_utr_nc.pbl``: ``trans_shadow_partial_utr.pbl``
  with the igenic row rewritten and the nc topology of ``_nc_transitions``
  added.  Initial and terminal probabilities are the UTR file's: no nc
  state starts or ends a sequence, so a noncoding gene always lies between
  two intergenic stretches.

The nc model trains no parameters of its own (its content is the intron
model's, its lengths the exon model's and a fixed negative binomial, its
transcript ends exist only at tss/tts/exonpart hints), so the UTR species
``repo_fixture_utr`` serves for ``--nc=on`` and this script writes no
species file.  The probabilities chosen:

* igenic: self loop 0.99956 (was 0.9996); the four UTR entries keep 1e-4
  each; the four nc entries (ncsingle, ncinit on the forward strand;
  rncsingle, rncterm, the leftmost exons of a reverse-strand transcript)
  get 1e-5 each, a tenth of a UTR entry, so that an nc transcript needs
  hint support to win over intergenic sequence, as it does in the
  reference (its nc exon states have no boundary track without hints).
* ncinit and ncinternal lead into the intron: 0.9 to the per-base chain
  ncintron, 0.1 to ncintronvar, the variable-length intron that exists
  only where an intron hint ends exactly at the splice site (so the 0.1
  matters only there).  The reverse strand mirrors it: rncterm and
  rncinternal to rncintron 0.9 and rncintronvar 0.1.
* ncintron is a per-base chain with the UTR introns' self loop of 0.99;
  it leaves to ncinternal with 0.003 and to ncterm with 0.007 (the UTR
  introns' exits), reverse: rncintron to rncinternal 0.003, rncinit 0.007.
* ncintronvar leaves to ncinternal 0.3 and ncterm 0.7 (the UTR intronvar
  states' exits); reverse rncintronvar to rncinternal 0.3, rncinit 0.7.
* ncsingle and ncterm end the transcript: 1.0 to igenic; on the reverse
  strand rncsingle and rncinit (the transcript's 5' end, at the right).

The hint fixture (``augustus_tpu_torch/data/hints/HS08198.nc.gff``, for
``tests/data/HS08198.fa`` with ``extrinsic.M.RM.E.W.nc.cfg``) reaches the
branches of the nc tracks that ``tests/data/nc_hints.gff`` (one tss, one
tts and one exon hint of a single forward exon) does not.  Its splice
sites are the sequence's own ``gt``/``ag`` (forward) and ``ct``/``ac``
(reverse) dinucleotides nearest to the positions below, so that the
intron hints end where the splice states may; sources E (bonuses of the
extrinsic config) and, once, M:

* a forward transcript of three exons: a tss at 100; an exonpart from 130
  to 10 bases before the first exon's end, so that the band of ncinit
  reaches back past the last 201 begins; a dss hint at the first intron's
  start; that intron given three times from one start (the ``gt`` after
  380): twice with one end (E and M, whose bonuses add up in
  ncintronvar) and once with the next ``ag`` 20 or more bases on; an ass
  hint at its end; an exonpart inside the second exon (part of it only,
  so that the local malus has uncovered bases to count); a per-base
  second intron with an intronpart hint; an exon hint and a tts on the
  third exon (80 bases);
* a reverse-strand transcript of three exons from 1400 on, mirrored: a tts
  at 1400, an exonpart inside its leftmost exon, ass and dss hints ('-')
  at the ends of the first intron, which an intron hint of source M gives
  (with E the transcript does not beat intergenic sequence), an
  exonpart over the middle exon, an intronpart hint in the second intron,
  an exon hint and a tss on the rightmost exon (90 bases).

``extrinsic.M.RM.E.W.nc.cfg`` is ``extrinsic.M.RM.E.W.cfg`` with a local
malus of .985 for exonpart hints (the nc model's local part malus; the
published layout's third number, 1 there, which turns it off).

Run from the repository root:  python3 augustus_tpu_torch/data/make_nc_fixture.py
"""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(HERE, "config", "model")
EXTRINSIC = os.path.join(HERE, "config", "extrinsic")
HINTS = os.path.join(HERE, "hints")
FASTA = os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests", "data",
                     "HS08198.fa")

NC_STATES = (
    "ncsingle", "ncinit", "ncintron", "ncintronvar", "ncinternal", "ncterm",
    "rncsingle", "rncinit", "rncintron", "rncintronvar", "rncinternal",
    "rncterm")
N = {name: 71 + i for i, name in enumerate(NC_STATES)}
IGENIC = 0
# the UTR file's igenic exits (make_utr_fixture.py): utr5single, utr5init,
# rutr3single, rutr3term
UTR_ENTRY = (47, 48, 65, 70)
IGENIC_SELF = 0.99956
UTR_ENTRY_P = 0.0001
NC_ENTRY_P = 0.00001


def _nc_transitions():
    """(from, to, probability, comment) of the igenic row and the nc
    topology."""
    t = []

    def add(comment, *edges):
        for i, (a, b, p) in enumerate(edges):
            t.append((a, b, p, comment if i == 0 else None))

    add("intergenic region: self loop, the four UTR entries and the four nc"
        " entries",
        (IGENIC, IGENIC, IGENIC_SELF),
        *[(IGENIC, u, UTR_ENTRY_P) for u in UTR_ENTRY],
        (IGENIC, N["ncsingle"], NC_ENTRY_P), (IGENIC, N["ncinit"], NC_ENTRY_P),
        (IGENIC, N["rncsingle"], NC_ENTRY_P),
        (IGENIC, N["rncterm"], NC_ENTRY_P))
    add("forward nc transcript: single | init -> intron -> internal* -> term",
        (N["ncsingle"], IGENIC, 1.0),
        (N["ncinit"], N["ncintron"], 0.9), (N["ncinit"], N["ncintronvar"], 0.1),
        (N["ncintron"], N["ncintron"], 0.99),
        (N["ncintron"], N["ncinternal"], 0.003),
        (N["ncintron"], N["ncterm"], 0.007),
        (N["ncintronvar"], N["ncinternal"], 0.3),
        (N["ncintronvar"], N["ncterm"], 0.7),
        (N["ncinternal"], N["ncintron"], 0.9),
        (N["ncinternal"], N["ncintronvar"], 0.1),
        (N["ncterm"], IGENIC, 1.0))
    add("reverse nc transcript, left to right: single | term -> intron ->"
        " internal* -> init",
        (N["rncsingle"], IGENIC, 1.0),
        (N["rncterm"], N["rncintron"], 0.9),
        (N["rncterm"], N["rncintronvar"], 0.1),
        (N["rncintron"], N["rncintron"], 0.99),
        (N["rncintron"], N["rncinternal"], 0.003),
        (N["rncintron"], N["rncinit"], 0.007),
        (N["rncintronvar"], N["rncinternal"], 0.3),
        (N["rncintronvar"], N["rncinit"], 0.7),
        (N["rncinternal"], N["rncintron"], 0.9),
        (N["rncinternal"], N["rncintronvar"], 0.1),
        (N["rncinit"], IGENIC, 1.0))
    return t


def states_cfg() -> str:
    with open(os.path.join(MODEL, "states_shadow_utr.cfg")) as fh:
        lines = fh.read().splitlines()
    out = ["# State architecture: forward and reverse (shadow) strand with UTRs",
           "# and noncoding transcripts.  States 0-70 as in",
           "# states_shadow_utr.cfg, nc states 71-82 (12).",
           "# Written by augustus_tpu_torch/data/make_nc_fixture.py."]
    for line in lines:
        if line.startswith("#"):
            continue
        if line.startswith("/NAMGene/statecount"):
            out.append("/NAMGene/statecount 83")
        else:
            out.append(line)
        if line.startswith("/NAMGene/state70"):
            out += [f"/NAMGene/state{s} ncmodel" for s in range(71, 83)]
    out += [f"/NcModel/type{i:02d} {name}" for i, name in enumerate(NC_STATES)]
    return "\n".join(out) + "\n"


def trans_pbl() -> str:
    with open(os.path.join(MODEL, "trans_shadow_partial_utr.pbl")) as fh:
        text = fh.read()
    head, body = text.split("[Initial]", 1)
    init, rest = body.split("[Transition]", 1)
    kept = []
    for line in rest.splitlines():
        f = line.split("#", 1)[0].split()
        if len(f) == 3 and int(f[0]) == IGENIC:
            continue        # the igenic row is rewritten below
        if line.startswith("# intergenic region"):
            continue
        kept.append(line)
    while kept and not kept[0].split("#", 1)[0].strip() \
            and not kept[0].startswith("# from"):
        kept.pop(0)
    out = [
        "# Transition, initial and terminal probabilities of the 83-state",
        "# shadow architecture with UTRs, noncoding transcripts and partial",
        "# genes (states as in states_shadow_utr_nc.cfg).  Written by",
        "# augustus_tpu_torch/data/make_nc_fixture.py from",
        "# trans_shadow_partial_utr.pbl.",
        "#",
        "# state numbers: 0-70 as in trans_shadow_partial_utr.pbl;",
        "#   71-76 " + " ".join(NC_STATES[:6]),
        "#   77-82 " + " ".join(NC_STATES[6:]),
        "",
        "[Initial]" + init.replace("71\n", "83\n", 1).rstrip("\n"),
        "",
        "[Transition]",
    ]
    out += [ln for ln in kept if ln.strip()]
    for a, b, p, comment in _nc_transitions():
        if comment:
            out.append("# " + comment)
        out.append(f"{a:<4} {b:<4} {p:g}")
    return "\n".join(out).replace(
        "[Terminal]\n# number of states\n71", "[Terminal]\n# number of "
        "states\n83") + "\n"


def nc_cfg() -> str:
    with open(os.path.join(EXTRINSIC, "extrinsic.M.RM.E.W.cfg")) as fh:
        lines = fh.read().splitlines()
    out = ["# extrinsic.M.RM.E.W.nc.cfg: extrinsic.M.RM.E.W.cfg with a local",
           "# malus of .985 for exonpart hints (the nc model's local part",
           "# malus).  Written by augustus_tpu_torch/data/make_nc_fixture.py."]
    for line in lines:
        if line.split()[:1] == ["exonpart"]:
            line = line.replace(".992  M", ".992 .985  M", 1)
        out.append(line)
    return "\n".join(out) + "\n"


def nc_hints() -> str:
    """The GFF text of the hint fixture of the module docstring."""
    with open(FASTA) as fh:
        seq = "".join(l.strip() for l in fh if not l.startswith(">")).upper()

    def site(pair, at_least):
        """1-based position of the first base of the first `pair` at or
        after `at_least`."""
        return seq.index(pair, at_least - 1) + 1

    rows = []

    def h(kind, a, b, strand, src="E"):
        rows.append(f"HS08198\tfixture\t{kind}\t{a}\t{b}\t0\t{strand}\t.\t"
                    f"src={src}")

    # forward transcript
    g1 = site("GT", 380)                 # intron 1 starts here
    e1 = site("AG", g1 + 60) + 1         # ... and ends at the g of an ag
    e1b = site("AG", e1 + 20) + 1        # the second end of the same start
    g2 = site("GT", e1 + 60)             # intron 2
    a2 = site("AG", g2 + 80) + 1
    h("tss", 100, 100, "+")
    h("exonpart", 130, g1 - 11, "+")
    h("dss", g1, g1, "+")
    h("intron", g1, e1, "+")
    h("intron", g1, e1, "+", "M")
    h("intron", g1, e1b, "+")
    h("ass", e1, e1, "+")
    h("exonpart", e1 + 6, g2 - 11, "+")
    h("intronpart", g2 + 10, a2 - 10, "+")
    h("exon", a2 + 1, a2 + 80, "+")
    h("tts", a2 + 80, a2 + 80, "+")
    # reverse transcript (left to right: 3' exon, intron, middle exon,
    # intron, 5' exon)
    c1 = site("CT", 1480)                # intron 1 starts with ct
    d1 = site("AC", c1 + 60) + 1         # ... and ends with ac
    c2 = site("CT", d1 + 60)
    d2 = site("AC", c2 + 80) + 1
    h("tts", 1400, 1400, "-")
    h("exonpart", 1410, c1 - 6, "-")
    h("ass", c1, c1, "-")
    h("intron", c1, d1, "-", "M")
    h("dss", d1, d1, "-")
    h("exonpart", d1 + 1, c2 - 1, "-")
    h("intronpart", c2 + 5, d2 - 5, "-")
    h("exon", d2 + 1, d2 + 90, "-")
    h("tss", d2 + 90, d2 + 90, "-")
    return "\n".join(rows) + "\n"


def main() -> None:
    with open(os.path.join(MODEL, "states_shadow_utr_nc.cfg"), "w") as fh:
        fh.write(states_cfg())
    with open(os.path.join(MODEL, "trans_shadow_partial_utr_nc.pbl"),
              "w") as fh:
        fh.write(trans_pbl())
    with open(os.path.join(EXTRINSIC, "extrinsic.M.RM.E.W.nc.cfg"),
              "w") as fh:
        fh.write(nc_cfg())
    with open(os.path.join(HINTS, "HS08198.nc.gff"), "w") as fh:
        fh.write(nc_hints())


if __name__ == "__main__":
    main()
