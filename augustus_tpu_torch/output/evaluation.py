"""Prediction-vs-annotation accuracy evaluation.

Port of `augustus_tpu/output/evaluation.py`.

Behavioral equivalent of the reference Evaluation class
(src/evaluation.cc): nucleotide / exon / gene level TP/FP/FN with
sensitivity/specificity, plus UTR TSS/TTS distance statistics, printed in the
exact table format of Evaluation::print (evaluation.cc:722).
"""

from __future__ import annotations

import math
from typing import List, Optional

MAXUTRDIST = 5000


def _w(s, n: int) -> str:
    return str(s).rjust(n)


def _p3(x: float) -> str:
    """C++ ostream setprecision(3) of a double; 0/0 prints -nan (x86)."""
    if isinstance(x, float) and math.isnan(x):
        return "-nan"
    return "%.3g" % x


class _Ex:
    __slots__ = ("begin", "end")

    def __init__(self, b: int, e: int):
        self.begin = b
        self.end = e


def _exlist(genes, attr="exons") -> List[_Ex]:
    out = []
    for g in genes:
        for e in getattr(g, attr, []):
            out.append(_Ex(e.begin, e.end))
    return out


def _sort_unique(exs: List[_Ex]) -> List[_Ex]:
    exs = sorted(exs, key=lambda e: (e.begin, e.end))
    out: List[_Ex] = []
    for e in exs:
        if not out or out[-1].begin != e.begin or out[-1].end != e.end:
            out.append(e)
    return out


class Evaluation:
    def __init__(self):
        z = 0
        self.nukTP = self.nukFP = self.nukFN = self.nukFPinside = z
        self.nucUTP = self.nucUFP = self.nucUFN = self.nucUFPinside = z
        self.exonTP = self.exonFP_partial = self.exonFP_overlapping = z
        self.exonFP_wrong = z
        self.exonFN_partial = self.exonFN_overlapping = self.exonFN_wrong = z
        self.UTRexonTP = self.UTRexonFP = self.UTRexonFN = z
        self.UTRoffThresh = 20
        self.geneTP = self.geneFN = z
        self.numPredExons = self.numAnnoExons = z
        self.numPredUTRExons = self.numAnnoUTRExons = z
        self.numUniquePredExons = self.numUniqueAnnoExons = z
        self.numUniquePredUTRExons = self.numUniqueAnnoUTRExons = z
        self.numPredGenes = self.numAnnoGenes = z
        self.numDataSets = z
        self.tssDist = [0] * (MAXUTRDIST + 1)
        self.ttsDist = [0] * (MAXUTRDIST + 1)
        self.numTotalPredTSS = self.numTSS = z
        self.numTotalPredTTS = self.numTTS = z
        self.quotients: List[float] = []
        self.leftFlankEnd = -1
        self.rightFlankBegin = -1
        # derived
        self.nukSens = self.nukSpec = float("nan")
        self.exonSens = self.exonSpec = float("nan")
        self.geneSens = self.geneSpec = float("nan")
        self.exonFP = self.exonFN = self.geneFP = 0
        self.UTRexonSens = self.UTRexonSpec = float("nan")
        self.nucUSens = self.nucUSpec = float("nan")
        self.meanTssDist = self.meanTtsDist = -1.0
        self.medianTssDist = self.medianTtsDist = -1

    # ------------------------------------------------------------------
    def add_to_evaluation(self, predicted, annotated, strand: str = "both",
                          quotient: Optional[float] = 0.0) -> None:
        """reference Evaluation::addToEvaluation (evaluation.cc:18)."""
        self.leftFlankEnd = -1
        self.rightFlankBegin = -1
        for a in annotated:
            gb = a.gene_begin()
            if (self.leftFlankEnd == -1 and gb > 0) or \
                    (self.leftFlankEnd >= 0 and gb - 1 < self.leftFlankEnd):
                self.leftFlankEnd = gb - 1
            if self.rightFlankBegin == -1 or \
                    a.gene_end() + 1 > self.rightFlankBegin:
                self.rightFlankBegin = a.gene_end() + 1
        if self.rightFlankBegin == -1:
            for p in predicted:
                if p.gene_end() + 1 > self.rightFlankBegin:
                    self.rightFlankBegin = p.gene_end() + 1

        pred_fw = [g for g in predicted if g.strand == "+"]
        pred_bw = [g for g in predicted if g.strand == "-"]
        anno_fw = [g for g in annotated if g.strand == "+"]
        anno_bw = [g for g in annotated if g.strand == "-"]
        if strand in ("both", "+"):
            self._add_one(pred_fw, anno_fw)
        if strand in ("both", "-"):
            self._add_one(pred_bw, anno_bw)
        if quotient is not None and not (quotient < 0.0):
            self.quotients.insert(0, quotient)

    def _add_one(self, pred_genes, anno_genes) -> None:
        pe = _exlist(pred_genes)
        ae = _exlist(anno_genes)
        self.numAnnoExons += len(ae)
        self.numPredExons += len(pe)
        pe = _sort_unique(pe)
        ae = _sort_unique(ae)
        self.numUniqueAnnoExons += len(ae)
        self.numUniquePredExons += len(pe)

        self._eval_nucleotide(pe, ae, utr=False)
        self._eval_exon(pe, ae, utr=False)
        self._eval_gene(pred_genes, anno_genes)
        self._eval_utr(pred_genes, anno_genes)

        # derived
        self.nukSens = _div(self.nukTP, self.nukTP + self.nukFN)
        self.nukSpec = _div(self.nukTP, self.nukTP + self.nukFP)
        self.exonFP = self.exonFP_wrong + self.exonFP_partial \
            + self.exonFP_overlapping
        self.exonFN = self.exonFN_wrong + self.exonFN_partial \
            + self.exonFN_overlapping
        self.exonSens = _div(self.exonTP, self.exonTP + self.exonFN)
        self.exonSpec = _div(self.exonTP, self.exonTP + self.exonFP)
        self.geneFP = self.numPredGenes - self.geneTP
        self.geneSens = _div(self.geneTP, self.geneTP + self.geneFN)
        self.geneSpec = _div(self.geneTP, self.geneTP + self.geneFP)
        self.UTRexonSens = _div(self.UTRexonTP,
                                self.UTRexonTP + self.UTRexonFN)
        self.UTRexonSpec = _div(self.UTRexonTP,
                                self.UTRexonTP + self.UTRexonFP)
        self.nucUSens = _div(self.nucUTP, self.nucUTP + self.nucUFN)
        self.nucUSpec = _div(self.nucUTP, self.nucUTP + self.nucUFP)
        self.numDataSets += 1

    # ------------------------------------------------------------------
    def _eval_nucleotide(self, pred: List[_Ex], anno: List[_Ex],
                         utr: bool) -> None:
        n = 0
        for e in anno:
            if e.end > n:
                n = e.end
        for e in pred:
            if e.end > n:
                n = e.end
        nuc = bytearray(n + 1)
        for e in pred:
            for i in range(max(e.begin, 0), e.end + 1):
                nuc[i] |= 2
                if self.leftFlankEnd < i < self.rightFlankBegin:
                    nuc[i] |= 4
        for e in anno:
            for i in range(max(e.begin, 0), e.end + 1):
                nuc[i] |= 1
        tp = fp = fpin = fn = 0
        for i in range(n + 1):
            f = nuc[i]
            if f == 1:
                fn += 1
            if (f & 1) == 0 and (f & 2):
                fp += 1
            if (f & 1) == 0 and (f & 4):
                fpin += 1
            if (f & 1) and (f & 2):
                tp += 1
        if not utr:
            self.nukFN += fn
            self.nukFP += fp
            self.nukFPinside += fpin
            self.nukTP += tp
        else:
            self.nucUFN += fn
            self.nucUFP += fp
            self.nucUFPinside += fpin
            self.nucUTP += tp

    def _eval_exon(self, pred: List[_Ex], anno: List[_Ex],
                   utr: bool) -> None:
        thr = self.UTRoffThresh
        for ex in pred:
            klasse = 0
            for an in anno:
                if not (ex.begin > an.end or ex.end < an.begin):
                    klasse = max(klasse, 1)
                if ex.begin == an.begin or ex.end == an.end:
                    klasse = max(klasse, 2)
                if abs(ex.begin - an.begin) <= thr and \
                        abs(ex.end - an.end) <= thr:
                    klasse = max(klasse, 3)
                if ex.begin == an.begin and ex.end == an.end:
                    klasse = max(klasse, 4)
            if not utr:
                if klasse == 0:
                    self.exonFP_wrong += 1
                elif klasse == 1:
                    self.exonFP_overlapping += 1
                elif klasse in (2, 3):
                    self.exonFP_partial += 1
                elif klasse == 4:
                    self.exonTP += 1
            else:
                if klasse in (3, 4):
                    self.UTRexonTP += 1
                else:
                    self.UTRexonFP += 1
        for an in anno:
            klasse = 0
            for ex in pred:
                if not (an.begin > ex.end or an.end < ex.begin):
                    klasse = max(klasse, 1)
                if an.begin == ex.begin or an.end == ex.end:
                    klasse = max(klasse, 2)
                if abs(an.begin - ex.begin) <= thr and \
                        abs(an.end - ex.end) <= thr:
                    klasse = max(klasse, 3)
                if an.begin == ex.begin and an.end == ex.end:
                    klasse = max(klasse, 4)
            if not utr:
                if klasse == 0:
                    self.exonFN_wrong += 1
                elif klasse == 1:
                    self.exonFN_overlapping += 1
                elif klasse in (2, 3):
                    self.exonFN_partial += 1
            else:
                if klasse == 0 or klasse == 1 or klasse == 2:
                    self.UTRexonFN += 1

    def _eval_gene(self, pred_genes, anno_genes) -> None:
        for an in anno_genes:
            self.numAnnoGenes += 1
            correct = False
            for pr in pred_genes:
                aex = [(e.begin, e.end) for e in an.exons]
                pex = [(e.begin, e.end) for e in pr.exons]
                if aex == pex and getattr(pr, "complete", True):
                    correct = True
                    break
            if correct:
                self.geneTP += 1
            else:
                self.geneFN += 1
        # count unique predicted CDS
        seen_sigs = []
        for pr in pred_genes:
            sig = self._exin_sig(pr)
            if sig not in seen_sigs:
                self.numPredGenes += 1
            seen_sigs.append(sig)

    @staticmethod
    def _exin_sig(g) -> tuple:
        return (tuple((e.begin, e.end) for e in g.exons),
                tuple((i.begin, i.end) for i in getattr(g, "introns", [])))

    def _eval_utr(self, pred_genes, anno_genes) -> None:
        for pr in pred_genes:
            pred_tss = pr.transstart if pr.strand == "+" else pr.transend
            pred_tis = pr.codingstart if pr.strand == "+" else pr.codingend
            if pred_tss >= 0 and getattr(pr, "complete5utr", True):
                self.numTotalPredTSS += 1
                for an in anno_genes:
                    anno_tss = an.transstart if an.strand == "+" \
                        else an.transend
                    anno_tis = an.codingstart if an.strand == "+" \
                        else an.codingend
                    if anno_tis == pred_tis and anno_tss >= 0:
                        diff = abs(pred_tss - anno_tss)
                        self.numTSS += 1
                        if diff <= MAXUTRDIST:
                            self.tssDist[diff] += 1
        for pr in pred_genes:
            pred_tts = pr.transend if pr.strand == "+" else pr.transstart
            pred_stp = pr.codingend if pr.strand == "+" else pr.codingstart
            if pred_tts >= 0 and getattr(pr, "complete3utr", True):
                self.numTotalPredTTS += 1
                for an in anno_genes:
                    anno_tts = an.transend if an.strand == "+" \
                        else an.transstart
                    anno_stp = an.codingend if an.strand == "+" \
                        else an.codingstart
                    if anno_stp == pred_stp and anno_tts >= 0:
                        diff = abs(pred_tts - anno_tts)
                        self.numTTS += 1
                        if diff <= MAXUTRDIST:
                            self.ttsDist[diff] += 1
        # UTR exon lists: per gene, 5' then 3' (as the reference builds them)
        pue = []
        for g in pred_genes:
            pue += _exlist([g], "utr5exons") + _exlist([g], "utr3exons")
        aue = []
        for g in anno_genes:
            aue += _exlist([g], "utr5exons") + _exlist([g], "utr3exons")
        self.numAnnoUTRExons += len(aue)
        self.numPredUTRExons += len(pue)
        pue = _sort_unique(pue)
        aue = _sort_unique(aue)
        self.numUniqueAnnoUTRExons += len(aue)
        self.numUniquePredUTRExons += len(pue)
        self._eval_exon(pue, aue, utr=True)
        self._eval_nucleotide(pue, aue, utr=True)

    # ------------------------------------------------------------------
    def finish(self, out: List[str]) -> None:
        """reference Evaluation::finishEvaluation (evaluation.cc:668)."""
        for name, dist, num in (("TSS", self.tssDist, self.numTSS),
                                ("TTS", self.ttsDist, self.numTTS)):
            if num > 0:
                mean = 0.0
                num_in_range = 0
                median = -1
                cum = 0
                out.append("%s distances " % name)
                for i in range(MAXUTRDIST + 1):
                    if dist[i] > 0:
                        cum += dist[i]
                        if 2 * cum >= num and median < 0:
                            median = i
                        mean += i * dist[i]
                        num_in_range += dist[i]
                        out.append("%d\ttimes:%d" % (i, dist[i]))
                if num - num_in_range > 0:
                    out.append("Warning: %d %s are off by more than %d"
                               % (num - num_in_range, name, MAXUTRDIST))
                mean += MAXUTRDIST * (num - num_in_range)
                mean /= num
            else:
                median = -1
                mean = -1.0
            if name == "TSS":
                self.meanTssDist, self.medianTssDist = mean, median
            else:
                self.meanTtsDist, self.medianTtsDist = mean, median

    def print_quotients(self, out: List[str]) -> None:
        out.append("a-posteriori probability of viterbi path")
        out.append("----------------------------------------")
        out.append("a-posteriori probability of correct path")
        out.append("")
        qs = sorted(self.quotients)
        one = 0
        i = 0
        while i < len(qs) and qs[i] < 1.000001:
            one += 1
            i += 1
        out.append("%d times were the paths equally likely (identical)."
                   % one)
        out.append("sorted quotients of the rest:")
        ten = 0
        while i < len(qs):
            out.append(_p3(qs[i]))
            if qs[i] < 10.0:
                ten += 1
            i += 1
        out.append("")
        out.append("%d quotients were between 1 and 10" % ten)
        out.append("")

    def print_tables(self, out: List[str]) -> None:
        """reference Evaluation::print (evaluation.cc:722)."""
        out.append("")
        out.append("*******      Evaluation of gene prediction     *******")
        out.append("")
        # nucleotide level
        out.append("---------------------------------------------\\")
        out.append("%s | %s | %s |" % (_w(" ", 16), _w("sensitivity", 11),
                                       _w("specificity", 11)))
        out.append("---------------------------------------------|")
        out.append("%s | %s | %s |" % (_w("nucleotide level", 16),
                                       _w(_p3(self.nukSens), 11),
                                       _w(_p3(self.nukSpec), 11)))
        out.append("---------------------------------------------/")
        out.append("")
        # exon level
        out.append("-" * 106 + "\\")
        out.append("%s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w(" ", 10), _w("#pred", 6), _w("#anno", 6),
                      _w(" ", 4), _w("FP = false pos.", 18),
                      _w("FN = false neg.", 18), _w(" ", 11), _w(" ", 11)))
        out.append("%s | %s | %s | %s |%s|%s| %s | %s |"
                   % (_w(" ", 10), _w("total/", 6), _w("total/", 6),
                      _w("TP", 4), _w("--------------------", 19),
                      _w("--------------------", 19),
                      _w("sensitivity", 11), _w("specificity", 11)))
        out.append("%s | %s | %s | %s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w(" ", 10), _w("unique", 6), _w("unique", 6),
                      _w(" ", 4), _w("part", 4), _w("ovlp", 4),
                      _w("wrng", 4), _w("part", 4), _w("ovlp", 4),
                      _w("wrng", 4), _w(" ", 11) + " | " + _w(" ", 11)))
        out.append("-" * 106 + "|")
        out.append("%s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w(" ", 10), _w(" ", 6), _w(" ", 6), _w(" ", 4),
                      _w(self.exonFP, 18), _w(self.exonFN, 18),
                      _w(" ", 11), _w(" ", 11)))
        out.append("%s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w("exon level", 10), _w(self.numPredExons, 6),
                      _w(self.numAnnoExons, 6), _w(self.exonTP, 4),
                      _w("------------------", 18),
                      _w("------------------", 18),
                      _w(_p3(self.exonSens), 11),
                      _w(_p3(self.exonSpec), 11)))
        out.append("%s | %s | %s | %s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w(" ", 10), _w(self.numUniquePredExons, 6),
                      _w(self.numUniqueAnnoExons, 6), _w(" ", 4),
                      _w(self.exonFP_partial, 4),
                      _w(self.exonFP_overlapping, 4),
                      _w(self.exonFP_wrong, 4),
                      _w(self.exonFN_partial, 4),
                      _w(self.exonFN_overlapping, 4),
                      _w(self.exonFN_wrong, 4),
                      _w(" ", 11) + " | " + _w(" ", 11)))
        out.append("-" * 106 + "/")
        out.append("")
        # transcript level
        out.append("-" * 76 + "\\")
        out.append("%s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w("transcript", 10), _w("#pred", 5), _w("#anno", 5),
                      _w("TP", 4), _w("FP", 4), _w("FN", 4),
                      _w("sensitivity", 11), _w("specificity", 9)))
        out.append("-" * 76 + "|")
        out.append("%s | %s | %s | %s | %s | %s | %s | %s |"
                   % (_w("gene level", 10), _w(self.numPredGenes, 5),
                      _w(self.numAnnoGenes, 5), _w(self.geneTP, 4),
                      _w(self.geneFP, 4), _w(self.geneFN, 4),
                      _w(_p3(self.geneSens), 11),
                      _w(_p3(self.geneSpec), 11)))
        out.append("-" * 76 + "/")
        if self.numTotalPredTSS > 0 or self.numTotalPredTTS > 0:
            t = self
            out.append("")
            out.append("-" * 72 + "\\")
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("UTR", 15), _w("total pred", 10),
                          _w("CDS bnd. corr.", 14), _w("meanDiff", 10),
                          _w("medianDiff", 10)))
            out.append("-" * 72 + "|")
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("TSS", 15), _w(t.numTotalPredTSS, 10),
                          _w(t.numTSS, 14), _w(_p3(t.meanTssDist), 10),
                          _w(t.medianTssDist, 10)))
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("TTS", 15), _w(t.numTotalPredTTS, 10),
                          _w(t.numTTS, 14), _w(_p3(t.meanTtsDist), 10),
                          _w(t.medianTtsDist, 10)))
            out.append("-" * 72 + "|")
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("UTR", 15), _w("uniq. pred", 10),
                          _w("unique anno", 14), _w("   sens.", 10),
                          _w("     spec.", 10)))
            out.append("-" * 72 + "|")
            out.append("%s | %s%d%s |"
                       % (_w(" ", 15),
                          _w("true positive = 1 bound. exact, 1 bound. <= ",
                             45), t.UTRoffThresh, "bp off"))
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("UTR exon level", 15),
                          _w(t.numUniquePredUTRExons, 10),
                          _w(t.numUniqueAnnoUTRExons, 14),
                          _w(_p3(t.UTRexonSens), 10),
                          _w(_p3(t.UTRexonSpec), 10)))
            out.append("-" * 72 + "|")
            out.append("%s | %s | %s | %s | %s |"
                       % (_w("UTR base level", 15),
                          _w(t.nucUTP + t.nucUFP, 10),
                          _w(t.nucUTP + t.nucUFN, 14),
                          _w(_p3(t.nucUSens), 10), _w(_p3(t.nucUSpec), 10)))
            out.append("-" * 72 + "/")
            out.append("nucUTP= %d nucUFP=%d nucUFPinside= %d nucUFN=%d"
                       % (t.nucUTP, t.nucUFP, t.nucUFPinside, t.nucUFN))


def _div(a: int, b: int) -> float:
    if b == 0:
        return float("nan")
    return a / b
