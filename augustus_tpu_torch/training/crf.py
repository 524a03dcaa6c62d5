"""CRF (discriminative) training — Online Large Margin.

Reference: CRF::onlineLargeMarginTraining (src/merkmal.cc:379) invoked by
etraining --CRF=on (src/etraining.cc:218 CRFbuildParameters).  Per chunk
of training genes: predict with the current parameters, compare the
Viterbi gene structure against the annotation, and when they differ move
the feature weights (= log emission probabilities) towards the correct
path by a margin step

    b   = scorediffweight * max(0, viterbiScore - correctScore)
        + lossweight * loss                       (merkmal.cc:485)
    h_j = clamp(b / ||a||^2 * a_j, +-0.5),  a = correctCounts - viterbiCounts

with the loss of CRF::lossFct (merkmal.cc:858: per-nucleotide FP/FN from
Evaluation) and per-round b-capping at the outlier quantile
(capOutliers).  After each chunk the weights are renormalized back to
probability distributions per emission context (Parameters::updatePars).

Trained feature groups here: the exon FramedPatMMGroup emission patterns
(per frame, per GC class) and the intron PatMMGroup patterns — the two
largest CRF groups in the reference.  Path scores are taken in feature
space (sum of weights over the path's pattern counts); the reference uses
the full path emission probability (namgene.getPathEmiProb), whose
non-CRF terms largely cancel in the score difference of two parses of
the same sequence.

Port of `augustus_tpu/training/crf.py`.  Each training gene is predicted
with predict.predict_sequence on the trainer's device (`cuda` unless asked
otherwise): on the card the device route's tables (prefix.cu), the Viterbi
kernel K1 and the event walk K4; the weight update is host numpy.  The
tables are rebuilt from the model's emission arrays for every prediction,
so each one reads the weights of the chunk before it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import genetics

SCOREDIFF_WEIGHT = 0.05      # merkmal.cc:404
LOSS_WEIGHT = 2.0            # merkmal.cc:405
CHANGE_CAP = 0.5             # merkmal.cc:536-540
CAP_QUANTILE = 0.8           # capOutliers quantile (merkmal.cc:829)


def _coding_kmer_counts(codes: np.ndarray, genes, k: int,
                        k_intron: int) -> np.ndarray:
    """(3, 4^(k+1)) pattern counts of coding exons by frame +
    (4^(k_intron+1),) intron counts, concatenated flat.

    Frame convention mirrors the emission application in the engines:
    frame f at position j counts the (k+1)-mer ENDING at j when j's
    codon position is f; minus-strand genes are counted on the reverse
    complement (reference FramedPatMMGroup counting in exontrain.cc)."""
    npat = 4 ** (k + 1)
    ex = np.zeros((3, npat), dtype=np.int64)
    npat_i = 4 ** (k_intron + 1)
    intr = np.zeros(npat_i, dtype=np.int64)
    n = codes.shape[0]

    def count_cds(cds_codes: np.ndarray):
        ids = genetics.kmer_ids(cds_codes, k + 1)
        m = ids.shape[0]
        if m <= 0:
            return
        ends = np.arange(m) + k              # pattern end position
        frames = (ends + 1) % 3              # pos i has frame (i+1)%3
        ok = ids >= 0
        for f in range(3):
            sel = ok & (frames == f)
            if sel.any():
                ex[f] += np.bincount(ids[sel], minlength=npat)

    def count_intron(sub: np.ndarray):
        ids = genetics.kmer_ids(sub, k_intron + 1)
        ok = ids >= 0
        if ok.any():
            np.add.at(intr, ids[ok], 1)

    for g in genes:
        exons = sorted((b, e) for (b, e) in _exon_ranges(g))
        if not exons:
            continue
        cds = np.concatenate([codes[b: e + 1] for (b, e) in exons])
        if _strand(g) == "-":
            cds = genetics.reverse_complement(cds)
        count_cds(cds)
        for (b, e) in _intron_ranges(g):
            sub = codes[b: e + 1]
            if _strand(g) == "-":
                sub = genetics.reverse_complement(sub)
            count_intron(sub)
    return np.concatenate([ex.ravel(), intr])


def _exon_ranges(g):
    if hasattr(g, "exons") and g.exons and hasattr(g.exons[0], "begin"):
        return [(st.begin, st.end) for st in g.exons]
    return list(g.exons)


def _intron_ranges(g):
    if hasattr(g, "introns") and g.introns and \
            hasattr(g.introns[0], "begin"):
        return [(st.begin, st.end) for st in g.introns]
    return list(g.introns)


def _strand(g):
    return getattr(g, "strand", "+")


def _structures_equal(anno_genes, pred_genes) -> bool:
    a = sorted(((b, e) for g in anno_genes for (b, e) in _exon_ranges(g)))
    p = sorted(((b, e) for g in pred_genes for (b, e) in _exon_ranges(g)))
    return a == p


def _loss(codes_len: int, anno_genes, pred_genes) -> float:
    """CRF::lossFct via the Evaluation nucleotide counters."""
    from ..output.evaluation import Evaluation
    from ..predict import anno_to_gene
    ev = Evaluation()
    try:
        ev.add_to_evaluation(list(pred_genes), list(anno_genes),
                             strand="both", quotient=0.0)
        return 0.001 * (float(ev.nukFPinside) + float(ev.nukFN)) + \
            0.0004 * (float(ev.nucUFPinside) + float(ev.nucUFN))
    except Exception:
        cov_a = np.zeros(codes_len, dtype=bool)
        cov_p = np.zeros(codes_len, dtype=bool)
        for g in anno_genes:
            for (b, e) in _exon_ranges(g):
                cov_a[b: e + 1] = True
        for g in pred_genes:
            for (b, e) in _exon_ranges(g):
                cov_p[b: e + 1] = True
        return 0.001 * float((cov_a != cov_p).sum())


def _cap_outliers(bs: List[float]) -> List[float]:
    """capOutliers (merkmal.cc:828): cap at the CAP_QUANTILE quantile."""
    pos = sorted(b for b in bs if b > 0)
    if len(pos) < 3:
        return list(bs)
    cap = pos[min(len(pos) - 1, int(CAP_QUANTILE * len(pos)))]
    return [min(b, cap) for b in bs]


class CRFTrainer:
    """OLM training over exon/intron emission weights of a loaded model."""

    def __init__(self, model, rounds: int = 2, chunksize: int = 100,
                 scorediffweight: float = SCOREDIFF_WEIGHT,
                 lossweight: float = LOSS_WEIGHT, device=None):
        from ..predict import resolve_device
        self.model = model
        self.device = resolve_device(device)
        self.k = model.exp.k
        self.k_intron = model.inp.k
        self.rounds = rounds
        self.chunksize = chunksize
        self.sdw = scorediffweight
        self.lw = lossweight
        self.num_correct = 0
        self.num_seen = 0

    # weights live directly in the model's emission tables (per class)
    def _weights(self, c: int) -> np.ndarray:
        gcp = self.model.exp.gc[c]
        npat = 4 ** (self.k + 1)
        npat_i = 4 ** (self.k_intron + 1)
        w = np.zeros(3 * npat + npat_i)
        with np.errstate(divide="ignore"):
            for f in range(3):
                w[f * npat: (f + 1) * npat] = \
                    np.log(np.maximum(gcp.emiprobs[f], 1e-300))
            w[3 * npat:] = np.log(np.maximum(
                np.asarray(self.model.inp.gc[c].emiprobs, dtype=np.float64),
                1e-300))
        return w

    def _set_weights(self, c: int, w: np.ndarray) -> None:
        """updatePars: renormalize each emission context back to a
        probability distribution (Parameters::updatePars)."""
        npat = 4 ** (self.k + 1)
        gcp = self.model.exp.gc[c]
        for f in range(3):
            p = np.exp(w[f * npat: (f + 1) * npat])
            # normalize per context (first k bases fixed -> groups of 4)
            p = p.reshape(-1, 4)
            s = p.sum(axis=1, keepdims=True)
            p = np.where(s > 0, p / s, 0.25).ravel()
            gcp.emiprobs[f] = p
        p = np.exp(w[3 * npat:]).reshape(-1, 4)
        s = p.sum(axis=1, keepdims=True)
        self.model.inp.gc[c].emiprobs = \
            np.where(s > 0, p / s, 0.25).ravel()

    def _predict_genes(self, seq: str):
        from ..io.fasta import FastaRecord
        from ..predict import predict_sequence
        rec = FastaRecord(name="crftrain", sequence=seq)
        _, _, txs = predict_sequence(self.model, rec, device=self.device)
        return txs

    def train(self, singles, log=print) -> None:
        from ..predict import anno_to_gene
        m = len(singles)
        chunksize = min(self.chunksize, m)
        for rnd in range(1, self.rounds + 1):
            log(f"*** CRF training round {rnd} of {self.rounds} ***")
            for i in range(0, m, chunksize):
                chunk = singles[i: i + chunksize]
                bs: List[float] = []
                diffs: List[Tuple[int, np.ndarray]] = []
                for a in chunk:
                    codes = genetics.encode(a.sequence.lower())
                    # majority GC class of the sequence (the reference
                    # switches classes per position via ContentStairs)
                    from ..model import gc as gcmod
                    stairs = gcmod.compute_stairs(
                        codes, self.model.cn, self.model.decomp)
                    cls = int(np.bincount(stairs).argmax())
                    anno = [anno_to_gene(tg, a.seqname) for tg in a.genes]
                    pred = self._predict_genes(a.sequence)
                    self.num_seen += 1
                    if _structures_equal(anno, pred):
                        self.num_correct += 1
                        bs.append(0.0)
                        diffs.append((cls, None))
                        continue
                    cc = _coding_kmer_counts(codes, anno, self.k,
                                             self.k_intron)
                    vc = _coding_kmer_counts(codes, pred, self.k,
                                             self.k_intron)
                    w = self._weights(cls)
                    cs = float(w @ cc)
                    vs = float(w @ vc)
                    loss = _loss(len(codes), anno, pred)
                    b = self.sdw * max(0.0, vs - cs) + self.lw * loss
                    bs.append(b)
                    diffs.append((cls, cc - vc))
                bsc = _cap_outliers(bs)
                h: Dict[int, np.ndarray] = {}
                for bcap, (cls, avec) in zip(bsc, diffs):
                    if bcap <= 0.0 or avec is None:
                        continue
                    norm = float(avec @ avec)
                    if norm <= 0.0:
                        continue
                    change = np.clip(bcap / norm * avec,
                                     -CHANGE_CAP, CHANGE_CAP)
                    h[cls] = h.get(cls, 0) + change
                for cls, hv in h.items():
                    self._set_weights(cls, self._weights(cls) + hv)
                log(f"chunk {i // chunksize}: updated "
                    f"{sum(1 for b in bsc if b > 0)} of {len(chunk)}; "
                    f"correct so far {self.num_correct}/{self.num_seen}")
