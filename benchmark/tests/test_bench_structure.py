"""The rules of benchlib/structure.py hold on AUGUSTUS 3.5.0's own output
and see each planted fault."""

import os

import pytest

from benchlib import generator as g
from benchlib import structure as St

GOLDEN = os.path.join(g.SEQ_DIR, "golden_human_mpe_hints.gff")


def _per_sequence():
    """{seqname: (gff text of its genes, letters)} of the golden."""
    letters = dict(g.read_fasta(os.path.join(g.SEQ_DIR, "HS04636.fa"))
                   + g.read_fasta(os.path.join(g.SEQ_DIR, "HS08198.fa")))
    texts, block = {}, None
    for line in open(GOLDEN).read().splitlines():
        if line.startswith("# start gene"):
            block = [line]
        elif block is not None:
            block.append(line)
            if line.startswith("# end gene"):
                name = next(l.split("\t")[0] for l in block
                            if len(l.split("\t")) >= 9)
                texts.setdefault(name, []).extend(block)
                block = None
    return {k: ("\n".join(v), letters[k]) for k, v in texts.items()}


def test_augustus_output_keeps_every_rule():
    seqs = _per_sequence()
    assert set(seqs) == {"HS04636", "HS08198"}
    for text, letters in seqs.values():
        n, bad, notes = St.malformed(text, letters)
        assert n >= 1 and bad == 0, notes


def _edit_first(text, ftype, col, delta):
    out, done = [], False
    for line in text.splitlines():
        c = line.split("\t")
        if not done and len(c) >= 9 and c[2] == ftype:
            c[col] = str(int(c[col]) + delta)
            line, done = "\t".join(c), True
        out.append(line)
    return "\n".join(out)


def _edit_protein(text):
    k = text.index("# protein sequence = [") + len("# protein sequence = [")
    return text[:k] + ("W" if text[k] != "W" else "C") + text[k + 1:]


@pytest.mark.parametrize("edit", [
    lambda t: _edit_first(t, "CDS", 4, 3),        # first CDS end: splice
    lambda t: _edit_first(t, "CDS", 7, 1),        # a phase
    lambda t: _edit_first(t, "start_codon", 3, 3),
    lambda t: _edit_first(t, "stop_codon", 4, -3),
    _edit_protein,
], ids=["cds_end", "phase", "start_codon", "stop_codon", "protein"])
def test_a_planted_fault_breaks_a_rule(edit):
    text, letters = _per_sequence()["HS04636"]
    n, bad, _ = St.malformed(edit(text), letters)
    assert bad == 1


def test_translation_and_reverse_strand():
    assert St.translate("ATGTAAGGG") == "M*G"
    assert St.revcomp("AACGT") == "ACGTT"
    assert St.STOPS == {"TAA", "TAG", "TGA"}
