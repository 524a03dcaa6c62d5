"""bam2hints — spliced-alignment BAM to intron/exon(part) hints GFF.

Clean-room port of reference auxprogs/bam2hints/bam2hints.cc: CIGAR is
reduced to PSL-like match blocks (M/=/X extend or open blocks, D/N
advance the target, I the query, S/H/P ignored), blocks are re-filtered
by gap length (<= maxgaplen closes the gap, [minintronlen, maxintronlen]
is an intron, anything else drops the alignment — the blat2hints.pl
rules), and hints are derived per block position: intron hints between
blocks whose query gap is <= maxqgaplen and whose terminal blocks reach
minendblocklen; exonpart hints (ends trimmed by ep_cutoff), exon hints
for inner blocks and DSS/ASS site hints with --exonhints/--ssOn.  Hints
are flushed whenever the target sequence changes (name-sorted input
interleaves targets; the reference's seen-target sortedness check
compares char* pointers and thus never fires) — introns are sorted by
(start, end) and equal ones merged with a multiplicity count.

Host copy of `augustus_tpu/pipeline/bam2hints.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

from typing import Dict, List, TextIO

from .bam import BamReader


class Bam2Hints:
    def __init__(self, priority=4, maxgaplen=14, minintronlen=32,
                 maxintronlen=350000, maxqgaplen=5, ep_cutoff=10,
                 min_endblock_len=8, source="E", introns_only=True,
                 ss_on=False, mult=True, max_gene_len=400000,
                 score=0.0):
        self.pri = priority
        self.maxgap = maxgaplen
        self.minint = minintronlen
        self.maxint = maxintronlen
        self.maxqgap = maxqgaplen
        self.epcut = ep_cutoff
        self.minend = min_endblock_len
        self.source = source
        self.introns_only = introns_only
        self.ss_on = ss_on
        self.mult = mult
        self.maxgene = max_gene_len
        self.score = score
        if self.maxgap >= self.minint:
            raise ValueError("Need to have maxgaplen < minintronlen")

    def run(self, bam_path: str, out: TextIO) -> None:
        bam = BamReader(bam_path)
        # hint lists in the reference's print order
        lists: Dict[str, List] = {k: [] for k in
                                  ("exonpart", "intron", "exon",
                                   "DSS", "ASS")}
        target = -2

        def flush(tname: str) -> None:
            intr = sorted(lists["intron"])
            merged = []
            for h in intr:
                if self.mult and merged and merged[-1][0] == h[0] and \
                        merged[-1][1] == h[1]:
                    merged[-1][2] += 1
                else:
                    merged.append([h[0], h[1], 1])
            lists["intron"] = merged
            for label in ("exonpart", "intron", "exon", "DSS", "ASS"):
                rows = lists[label]
                if label != "intron":
                    rows = [[s, e, 1] for (s, e) in sorted(rows)]
                for (s, e, m) in rows:
                    extra = f"mult={m};" if m > 1 else ""
                    out.write(f"{tname}\tb2h\t{label}\t{s}\t{e}\t"
                              f"{self.score:g}\t.\t.\t{extra}"
                              f"pri={self.pri};src={self.source}\n")
                lists[label] = []

        for al in bam:
            # ---- CIGAR -> PSL-like blocks ---------------------------
            bad = False
            b: List[int] = []   # block lengths
            q: List[int] = []   # 1-based query starts
            t: List[int] = []   # 1-based target starts
            qo, to = 1, al.pos + 1
            for (ln, op) in al.cigar:
                if op in "MX=":
                    if b and t[-1] + b[-1] == to and q[-1] + b[-1] == qo:
                        b[-1] += ln
                    else:
                        b.append(ln)
                        q.append(qo)
                        t.append(to)
                    qo += ln
                    to += ln
                elif op in "HSP":
                    pass
                elif op in "DN":
                    to += ln
                elif op == "I":
                    qo += ln
                else:
                    bad = True
                    break
            if bad or (b and t[-1] + b[-1] - t[0] > self.maxgene):
                continue

            if al.ref_id != target:
                if target >= 0:
                    flush(bam.ref_names[target])
                target = al.ref_id

            # ---- re-filter blocks by gap length ---------------------
            begins: List[int] = []
            ends: List[int] = []
            fol_ok: List[bool] = []
            for i in range(len(b)):
                gap = self.minint if not begins else t[i] - ends[-1] - 1
                qgap_ok = (i < len(b) - 1 and
                           q[i + 1] - q[i] - b[i] <= self.maxqgap)
                if self.minint <= gap <= self.maxint:
                    begins.append(t[i])
                    ends.append(t[i] + b[i] - 1)
                    fol_ok.append(qgap_ok)
                elif gap <= self.maxgap:
                    ends[-1] = t[i] + b[i] - 1
                    fol_ok[-1] = qgap_ok
                else:
                    bad = True
                    break
            if bad:
                continue

            # ---- derive hints ---------------------------------------
            nb = len(begins)
            for i in range(nb):
                if i == 0:
                    if nb == 1 and not self.introns_only:
                        if ends[0] - begins[0] >= 2 * self.epcut:
                            lists["exonpart"].append(
                                (begins[0] + self.epcut,
                                 ends[0] - self.epcut))
                    elif nb > 1 and ends[0] - begins[0] + 1 >= self.minend:
                        if not self.introns_only and \
                                ends[0] - begins[0] >= self.epcut:
                            lists["exonpart"].append(
                                (begins[0] + self.epcut, ends[0]))
                        if self.ss_on and not self.introns_only:
                            for p in (ends[0] + 1, begins[1] - 1):
                                lists["DSS"].append((p, p))
                                lists["ASS"].append((p, p))
                        if fol_ok[0] and (nb > 2 or
                                          ends[1] - begins[1] + 1
                                          >= self.minend):
                            lists["intron"].append(
                                (ends[0] + 1, begins[1] - 1))
                elif i == nb - 1:
                    if not self.introns_only and \
                            ends[i] - begins[i] + 1 >= self.minend and \
                            ends[i] - begins[i] >= self.epcut:
                        lists["exonpart"].append(
                            (begins[i], ends[i] - self.epcut))
                else:
                    if not self.introns_only:
                        lists["exon"].append((begins[i], ends[i]))
                    if fol_ok[i] and (i < nb - 2 or
                                      ends[i + 1] - begins[i + 1] + 1
                                      >= self.minend):
                        lists["intron"].append(
                            (ends[i] + 1, begins[i + 1] - 1))
                        if self.ss_on and not self.introns_only:
                            for p in (ends[i] + 1, begins[i + 1] - 1):
                                lists["DSS"].append((p, p))
                                lists["ASS"].append((p, p))
        if target >= 0:
            flush(bam.ref_names[target])
