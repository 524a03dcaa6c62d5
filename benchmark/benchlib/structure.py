"""Every printed gene held to the record's letters, with no code of the
program or of the reference.

For each transcript of a GFF text (AUGUSTUS's layout: `# start gene` ...
`# end gene`, CDS / start_codon / stop_codon lines, `# protein sequence =
[...]`), written here from the standard genetic code alone:

  - its CDS segments lie on one strand, in order and apart;
  - each intron between two CDS segments begins with GT or GC and ends
    with AG (on the transcript's strand);
  - each CDS segment's phase follows from the one before it;
  - a start codon, where printed, is ATG at the first CDS base, with
    phase 0 there;
  - a stop codon, where printed, is TAA, TAG or TGA at the last CDS base,
    closing a whole number of codons;
  - the printed protein is the CDS letters translated from the first
    segment's phase, without the closing stop codon, an in-frame stop
    codon printed as X;
  - the transcript line spans its CDS and codons, and the gene line its
    transcript (untranslated regions and partial genes can reach past
    the CDS).

`malformed(text, letters)` counts the transcripts that break any of
these, and says which rule each broke.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_BASES = "TCAG"
_AMINO = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
CODE: Dict[str, str] = {a + b + c: _AMINO[16 * i + 4 * j + k]
                        for i, a in enumerate(_BASES)
                        for j, b in enumerate(_BASES)
                        for k, c in enumerate(_BASES)}
STOPS = {c for c, aa in CODE.items() if aa == "*"}
_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def translate(s: str) -> str:
    return "".join(CODE.get(s[i: i + 3], "X")
                   for i in range(0, len(s) - 2, 3))


class Transcript:
    def __init__(self, tid: str):
        self.tid = tid
        self.cds: List[Tuple[int, int, str, int]] = []
        self.start: List[Tuple[int, int]] = []
        self.stop: List[Tuple[int, int]] = []
        self.extent: Tuple[int, int] = (0, 0)
        self.protein = None


def _transcripts(block: List[str]) -> Tuple[Tuple[int, int],
                                            List[Transcript]]:
    """(the gene line's extent, its transcripts) of one gene block."""
    gene = (0, 0)
    txs: Dict[str, Transcript] = {}
    cur = None
    prot, in_prot = [], False
    for line in block:
        if in_prot or line.startswith("# protein sequence = ["):
            body = line[2:] if in_prot else line.split("[", 1)[1]
            in_prot = "]" not in body
            prot.append(body.split("]")[0].strip())
            if not in_prot and cur is not None:
                cur.protein = "".join(prot)
                prot = []
            continue
        c = line.split("\t")
        if len(c) < 9 or line.startswith("#"):
            continue
        a, b = int(c[3]), int(c[4])
        if c[2] == "gene":
            gene = (a, b)
        elif c[2] == "transcript":
            cur = txs.setdefault(c[8].strip(), Transcript(c[8].strip()))
            cur.extent = (a, b)
        else:
            m = re.search(r'transcript_id "([^"]+)"', c[8])
            if m is None:
                continue
            t = txs.setdefault(m.group(1), Transcript(m.group(1)))
            if c[2] == "CDS":
                t.cds.append((a, b, c[6], int(c[7])))
            elif c[2] == "start_codon":
                t.start.append((a, b))
            elif c[2] == "stop_codon":
                t.stop.append((a, b))
    return gene, list(txs.values())


def _letters(letters: str, segs, strand: str) -> str:
    """The spliced letters of 1-based segments, on the strand."""
    s = "".join(letters[a - 1: b] for a, b in sorted(segs))
    return s.upper() if strand == "+" else revcomp(s.upper())


def faults(t: Transcript, gene: Tuple[int, int], letters: str) -> List[str]:
    """The rules that one transcript breaks (empty when it keeps all)."""
    out = []
    if not t.cds:
        return ["no CDS"]
    segs = sorted(t.cds)
    strands = {s for _, _, s, _ in segs}
    if len(strands) != 1 or strands - {"+", "-"}:
        return ["CDS strands " + "".join(sorted(strands))]
    strand = strands.pop()
    for (a0, b0, _, _), (a1, _, _, _) in zip(segs, segs[1:]):
        if not a0 <= b0 < a1 - 1:
            out.append(f"CDS {a0}-{b0} not before {a1}")
            continue
        intron = _letters(letters, [(b0 + 1, a1 - 1)], strand)
        if intron[:2] not in ("GT", "GC") or intron[-2:] != "AG":
            out.append(f"intron {b0 + 1}-{a1 - 1} {intron[:2]}..{intron[-2:]}")
    order = segs if strand == "+" else segs[::-1]
    run = 0
    for k, (a, b, _, ph) in enumerate(order):
        want = ph if k == 0 else (3 - (run - order[0][3]) % 3) % 3
        if ph != want:
            out.append(f"phase {ph} at CDS {a}-{b}, not {want}")
        run += b - a + 1
    cds = _letters(letters, [(a, b) for a, b, _, _ in segs], strand)
    lo, hi = segs[0][0], segs[-1][1]
    first, last = (lo, hi) if strand == "+" else (hi, lo)
    p0 = order[0][3]
    if t.start:
        codon = _letters(letters, t.start, strand)
        ends = {a for a, _ in t.start} | {b for _, b in t.start}
        if codon != "ATG" or first not in ends or p0 != 0:
            out.append(f"start codon {codon} at {sorted(t.start)}")
    closed = False
    if t.stop:
        codon = _letters(letters, t.stop, strand)
        ends = {a for a, _ in t.stop} | {b for _, b in t.stop}
        closed = codon in STOPS and cds[-3:] == codon
        if not closed or last not in ends or (len(cds) - p0) % 3:
            out.append(f"stop codon {codon} at {sorted(t.stop)}")
    aa = translate(cds[p0:])
    if closed and aa.endswith("*"):
        aa = aa[:-1]
    aa = aa.replace("*", "X")
    if t.protein is not None and aa != t.protein:
        out.append("protein differs from the CDS letters' translation")
    span = (min([lo] + [a for a, _ in t.start + t.stop]),
            max([hi] + [b for _, b in t.start + t.stop]))
    if not (gene[0] <= t.extent[0] <= span[0] and
            span[1] <= t.extent[1] <= gene[1]):
        out.append(f"extent {t.extent} / gene {gene} against CDS {span}")
    return out


def malformed(text: str, letters: str) -> Tuple[int, int, List[str]]:
    """(transcripts checked, transcripts that break a rule, the first
    few of them with their faults) of a GFF text over its record."""
    n, bad, notes = 0, 0, []
    block = None
    for line in text.splitlines():
        if line.startswith("# start gene"):
            block = []
        if block is None:
            continue
        block.append(line)
        if line.startswith("# end gene"):
            gene, txs = _transcripts(block)
            for t in txs:
                n += 1
                f = faults(t, gene, letters)
                if f:
                    bad += 1
                    if len(notes) < 5:
                        notes.append(f"{t.tid}: " + "; ".join(f))
            block = None
    return n, bad, notes
