"""UTR model training (reference src/utrtrain.cc UtrModel::buildModel).

Per GC class: count 5'/3' UTR exon emissions ((k+1)-mer chains over the
exon interiors, class-weighted), train the TSS models (TATA vs TATA-less
promoter motifs + tss-upwindow chain, utrtrain.cc:179-375), the TTS model
(polyA-signal box search in [-d_polya_cleavage_max, -d_polya_cleavage_min]
relative to the transcript end + the cleavage motif, utrtrain.cc:215-340)
and — once, on the first class — the 8 smoothed exon length distributions
with geometric tails (utrtrain.cc:649-783, utrmodel.cc:294).  Stored
emissions are mixed with the intron chain by utr*prepatternweight
(storeGCPars, utrtrain.cc:843-880).

Counting order follows the C++ loops so the .pbl output is byte-exact.

Port of `augustus_tpu/training/utr.py`: host numpy, no kernel.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .annotation import AnnoSeq
from .models import _codes
from .motif import Motif
from .probs import compute_emi_from_pat, make_probs_from_counts
from .smooth import scale_dbl_vector, smooth_counts


def _kmer_at(codes: np.ndarray, pos: int, k1: int) -> int:
    """Seq2Int(k1) of codes[pos .. pos+k1-1]; -1 on N or out of range."""
    if pos < 0 or pos + k1 > codes.shape[0]:
        return -1
    pn = 0
    for j in range(k1):
        c = int(codes[pos + j])
        if c >= 4:
            return -1
        pn = (pn << 2) | c
    return pn


class UtrTrainer:
    def __init__(self, props, cn):
        self.props = props
        self.cn = cn
        g = props.get_int
        gf = props.get_float
        self.k = g("/UtrModel/k", 4)
        self.patpseudo = gf("/UtrModel/patpseudocount", 1.0)
        self.tssup_k = g("/UtrModel/tssup_k", 0)
        self.tssup_patpseudo = gf("/UtrModel/tssup_patpseudocount", 1.0)
        self.exonLenD = g("/UtrModel/exonlengthD", 1000)
        self.max_exon_length = g("/UtrModel/maxexonlength", 1500)
        self.max3single = g("/UtrModel/max3singlelength", 5500)
        self.max3term = g("/UtrModel/max3termlength", 3500)
        self.slope = gf("/UtrModel/slope_of_bandwidth", 0.1)
        self.minwindowcount = g("/UtrModel/minwindowcount", 3)
        self.tss_start = g("/UtrModel/tss_start", 4)
        self.tss_end = g("/UtrModel/tss_end", 4)
        self.tata_start = g("/UtrModel/tata_start", 1)
        self.tata_end = g("/UtrModel/tata_end", 10)
        self.tata_pseudocount = g("/UtrModel/tata_pseudocount", 1)
        self.d_tss_tata_min = g("/UtrModel/d_tss_tata_min", 17)
        self.d_tss_tata_max = g("/UtrModel/d_tss_tata_max", 40)
        self.d_polyasig_cleavage = g("/UtrModel/d_polyasig_cleavage", 24)
        self.d_polya_cleavage_min = g("/UtrModel/d_polya_cleavage_min", 10)
        self.d_polya_cleavage_max = g("/UtrModel/d_polya_cleavage_max", 35)
        self.tts_motif_memory = g("/UtrModel/tts_motif_memory", 1)
        self.boxlen = 6
        self.polyasig = props.get("/UtrModel/polyasig_consensus", "aataaa")
        self.utr5prew = gf("/UtrModel/utr5prepatternweight", 0.0)
        self.utr3prew = gf("/UtrModel/utr3prepatternweight", 0.0)
        self.tss_upwindow_size = cn.tss_upwindow_size
        self.trans_init_window = cn.trans_init_window
        self.dss_start = cn.dss_start
        self.ass_end = cn.ass_end

        self.has_len_dist = False
        self.gc_utr5init: Dict[int, np.ndarray] = {}
        self.gc_utr5: Dict[int, np.ndarray] = {}
        self.gc_utr3: Dict[int, np.ndarray] = {}
        self.gc_tssup: Dict[int, np.ndarray] = {}
        self.gc_tss_motif: Dict[int, Motif] = {}
        self.gc_tss_motif_tata: Dict[int, Motif] = {}
        self.gc_tata_motif: Dict[int, Motif] = {}
        self.gc_tts_motif: Dict[int, Motif] = {}

    # ------------------------------------------------------------------
    def build(self, annoseqs: List[AnnoSeq]) -> None:
        k = self.k
        self.tss_motif_tata = Motif(self.tss_end + self.tss_start, 0, 1)
        self.tss_motif = Motif(self.tss_end + self.tss_start, 0, 1)
        self.tts_motif = Motif(self.d_polyasig_cleavage,
                               self.tts_motif_memory, 1, 1)
        self.tata_motif = Motif(self.tata_start + self.tata_end, 0,
                                self.tata_pseudocount)
        if not self.has_len_dist:
            d = self.exonLenD
            self.len_counts = {key: np.zeros(d + 1, dtype=np.int64)
                               for key in ("5s", "5i", "5n", "5t",
                                           "3s", "3i", "3n", "3t")}
            self.num_huge = {key: 0 for key in self.len_counts}
            self.num = {key: 0 for key in self.len_counts}
            self.num5introns = self.num3introns = 0
        # initCountVars
        self.utr5_emicount = np.zeros(4 ** (k + 1), dtype=np.float64)
        self.utr5init_emicount = np.zeros(4 ** (k + 1), dtype=np.float64)
        self.utr3_emicount = np.zeros(4 ** (k + 1), dtype=np.float64)
        self.tssup_emicount = np.zeros(4 ** (self.tssup_k + 1),
                                       dtype=np.float64)

        self._build_tss(annoseqs)
        self._build_tts(annoseqs)
        self._build_probabilities(annoseqs)
        if not self.has_len_dist:
            self._compute_length_distributions()
        self.has_len_dist = True

    # ------------------------------------------------------------------
    def _gene(self, a: AnnoSeq):
        return a.genes[0] if a.genes else None

    def _build_tss(self, annoseqs) -> None:
        for a in annoseqs:
            g = self._gene(a)
            if g is None or not g.utr5exons:
                continue
            dnalen = len(a.sequence)
            tsspos = g.utr5exons[0][0]
            if (tsspos - self.tss_upwindow_size) > 0 and \
                    (tsspos + self.tss_end - 1 < dnalen):
                self._process_tss(_codes(a),
                                  tsspos - self.tss_upwindow_size)
        patternprobs = make_probs_from_counts(
            self.tssup_emicount, self.tssup_k, self.tssup_patpseudo)
        self.tssup_emiprobs = compute_emi_from_pat(patternprobs,
                                                   self.tssup_k)

    def _find_tata(self, codes: np.ndarray, start: int, maxpos: int) -> int:
        t, aa = 3, 0
        for pos in range(0, maxpos + 1):
            p = start + pos
            if codes[p] == t and codes[p + 1] == aa and codes[p + 2] == t \
                    and codes[p + 3] == aa and codes[p + 5] == aa:
                return pos
        return -1

    def _process_tss(self, codes: np.ndarray, start: int) -> None:
        """utrtrain.cc:352 processTSS; ``start`` = window begin index."""
        upwin = self.tss_upwindow_size
        tatawinbegin = upwin - self.d_tss_tata_max
        tatapos = self._find_tata(codes, start + tatawinbegin,
                                  self.d_tss_tata_max - self.d_tss_tata_min)
        if tatapos > -1:
            self.tss_motif_tata.add_sequence(
                codes, start + upwin - self.tss_start, 1)
            self.tata_motif.add_sequence(
                codes, start + tatawinbegin + tatapos - self.tata_start, 1)
            self._process_tssup(codes, start,
                                start + tatawinbegin + tatapos
                                - self.tata_start - 1)
            self._process_tssup(codes,
                                start + tatawinbegin + tatapos
                                + self.tata_end,
                                start + upwin - self.tss_start - 1)
        else:
            self.tss_motif.add_sequence(
                codes, start + upwin - self.tss_start, 1)
            self._process_tssup(codes, start,
                                start + upwin - self.tss_start - 1)

    def _process_tssup(self, codes, lo: int, hi: int) -> None:
        k1 = self.tssup_k + 1
        for p in range(lo, hi + 1):
            pn = _kmer_at(codes, p - self.tssup_k, k1)
            if pn >= 0:
                self.tssup_emicount[pn] += 1

    # ------------------------------------------------------------------
    def _build_tts(self, annoseqs) -> None:
        boxlen = self.boxlen
        npat = 4 ** boxlen
        probs = np.zeros(npat)
        count = np.zeros(npat, dtype=np.int64)

        def s2i(s: str) -> int:
            pn = 0
            for ch in s:
                pn = (pn << 2) | "acgt".index(ch)
            return pn

        if self.polyasig == "aataaa":
            for pat, pr in (("aataaa", .651), ("attaaa", .170),
                            ("tataaa", .035), ("agtaaa", .030),
                            ("aatata", .021), ("cataaa", .016),
                            ("gataaa", .016), ("aataca", .014),
                            ("aagaaa", .013), ("aatgaa", .010),
                            ("aataga", .009), ("actaaa", .008),
                            ("aaaaaa", .001), ("aacaaa", .001),
                            ("aatcaa", .001), ("aattaa", .001),
                            ("aataac", .001), ("aataag", .001),
                            ("aataat", .001)):
                probs[s2i(pat)] = pr
        elif self.polyasig == "tgtaac":
            for pat, pr in (("tgtaac", .387), ("tgtaaa", .212),
                            ("tgtaag", .206), ("tgtaat", .195)):
                probs[s2i(pat)] = pr
        else:
            probs[s2i(self.polyasig)] = 0.01
        count_found = 0
        bestpn = -1
        for a in annoseqs:
            g = self._gene(a)
            if g is None or not g.complete_r or g.transend < 0:
                continue
            codes = _codes(a)
            n = len(a.sequence)
            found = False
            bestpos = 999
            lo = g.transend - self.d_polya_cleavage_max - boxlen + 1
            hi = g.transend - self.d_polya_cleavage_min - boxlen + 1
            for pos in range(hi, lo - 1, -1):
                if 0 <= pos < n - boxlen:
                    pn = _kmer_at(codes, pos, boxlen)
                    if pn < 0:
                        continue
                    if (found and probs[pn] > probs[bestpn]) or \
                            (not found and probs[pn] > 0.0):
                        bestpn = pn
                        bestpos = pos - lo
                        found = True
            if found:
                count[bestpn] += 1
                self.tts_motif.add_sequence(
                    codes, g.transend - self.d_polya_cleavage_max + 1
                    + bestpos, g.weight)
                count_found += 1
        threshold = 0.01
        new_count_found = 0
        for i in range(npat):
            if count[i] > 0 and count[i] < threshold * count_found:
                count[i] = 0
            new_count_found += count[i]
        if new_count_found > 0:
            self.aataaa_probs = count.astype(np.float64) / new_count_found
        else:
            self.aataaa_probs = np.zeros(npat)

    # ------------------------------------------------------------------
    def _build_probabilities(self, annoseqs) -> None:
        k = self.k
        for a in annoseqs:
            g = self._gene(a)
            if g is None or not (g.utr5exons or g.utr3exons):
                continue
            self._process_states(_codes(a), g)
        pats = make_probs_from_counts(self.utr5_emicount, k, self.patpseudo)
        self.utr5_emiprobs = compute_emi_from_pat(pats, k)
        pats = make_probs_from_counts(self.utr5init_emicount, k,
                                      self.patpseudo)
        self.utr5init_emiprobs = compute_emi_from_pat(pats, k)
        pats = make_probs_from_counts(self.utr3_emicount, k, self.patpseudo)
        self.utr3_emiprobs = compute_emi_from_pat(pats, k)

    def _count_range(self, codes, counts, lo: int, hi: int, w) -> None:
        """counts[s2i(codes[p-k .. p])] += w for p in [lo, hi]."""
        k = self.k
        for p in range(lo, hi + 1):
            pn = _kmer_at(codes, p - k, k + 1)
            if pn >= 0:
                counts[pn] += w

    def _len_count(self, key: str, length: int, with_len: bool) -> None:
        if self.has_len_dist or not with_len:
            return
        if key in ("3s",):
            if length <= self.exonLenD and length > 2:
                self.len_counts[key][length] += 1
            elif length > self.exonLenD:
                self.num_huge[key] += 1
        elif length <= self.exonLenD:
            self.len_counts[key][length] += 1
        else:
            self.num_huge[key] += 1
        self.num[key] += 1

    def _process_states(self, codes, g) -> None:
        w = g.weight
        k = self.k
        # 5' UTR (utrtrain.cc:381)
        if g.utr5exons:
            exs = g.utr5exons
            if len(exs) == 1:
                b, e = exs[0]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr5init_emicount,
                                      b + self.tss_end + k,
                                      e - self.trans_init_window, w)
                    self._len_count("5s", e - b + 1, bool(g.exons))
            else:
                b, e = exs[0]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr5init_emicount,
                                      b + self.tss_end + k,
                                      e - self.dss_start, w)
                    self._len_count("5i", e - b + 1, True)
                for (b, e) in exs[1:-1]:
                    if e - b + 1 >= 1:
                        self._count_range(codes, self.utr5_emicount,
                                          b + self.ass_end + k,
                                          e - self.dss_start, w)
                        self._len_count("5n", e - b + 1, True)
                    if not self.has_len_dist:
                        self.num5introns += 1
                b, e = exs[-1]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr5_emicount,
                                      b + self.ass_end + k,
                                      e - self.trans_init_window, w)
                    self._len_count("5t", e - b + 1, True)
                if not self.has_len_dist:
                    self.num5introns += 1
        # 3' UTR (utrtrain.cc:428)
        if g.utr3exons:
            exs = g.utr3exons
            if len(exs) == 1:
                b, e = exs[0]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr3_emicount, b + k, e, w)
                    self._len_count("3s", e - b + 1,
                                    bool(g.exons) and g.complete_r)
            else:
                b, e = exs[0]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr3_emicount, b + k,
                                      e - self.dss_start, w)
                    self._len_count("3i", e - b + 1, True)
                for (b, e) in exs[1:-1]:
                    if e - b + 1 >= 1:
                        self._count_range(codes, self.utr3_emicount,
                                          b + self.ass_end + k,
                                          e - self.dss_start, w)
                        self._len_count("3n", e - b + 1, True)
                    if not self.has_len_dist:
                        self.num3introns += 1
                b, e = exs[-1]
                if e - b + 1 >= 1:
                    self._count_range(codes, self.utr3_emicount,
                                      b + self.ass_end + k, e, w)
                    self._len_count("3t", e - b + 1, g.complete_r)
                if not self.has_len_dist:
                    self.num3introns += 1

    # ------------------------------------------------------------------
    def _compute_length_distributions(self) -> None:
        self.len_dists = {}
        sizes = {"5s": self.max_exon_length, "5i": self.max_exon_length,
                 "5n": self.max_exon_length, "5t": self.max_exon_length,
                 "3s": self.max3single, "3i": self.max_exon_length,
                 "3n": self.max_exon_length, "3t": self.max3term}
        for key, maxlen in sizes.items():
            dist = smooth_counts(self.len_counts[key], self.minwindowcount,
                                 self.slope, prior_size=maxlen + 1)
            num, huge = self.num[key], self.num_huge[key]
            scale_dbl_vector(dist, float(num - huge) / num if num else 0.0)
            # geometric tail (utrmodel.cc:294 fillTailsOfLengthDistributions)
            a = float(dist[self.exonLenD])
            p = 1.0 - a / ((float(huge) + 1) / (num + 1))
            for kk in range(self.exonLenD + 1, maxlen + 1):
                dist[kk] = p * dist[kk - 1]
            self.len_dists[key] = dist

    # ------------------------------------------------------------------
    def store_gc(self, idx: int, intron_trainer) -> None:
        """utrtrain.cc storeGCPars: mix with the intron chain, snapshot."""
        k = self.k
        iem = intron_trainer.gc_emiprobs[idx]
        u5i = self.utr5init_emiprobs * self.utr5prew + \
            iem * (1.0 - self.utr5prew)
        u5 = self.utr5_emiprobs * self.utr5prew + iem * (1.0 - self.utr5prew)
        u3 = self.utr3_emiprobs * self.utr3prew + iem * (1.0 - self.utr3prew)
        self.gc_utr5init[idx] = u5i
        self.gc_utr5[idx] = u5
        self.gc_utr3[idx] = u3
        self.gc_tssup[idx] = self.tssup_emiprobs.copy()
        for mname, store in (("tss_motif", self.gc_tss_motif),
                             ("tss_motif_tata", self.gc_tss_motif_tata),
                             ("tata_motif", self.gc_tata_motif),
                             ("tts_motif", self.gc_tts_motif)):
            m = getattr(self, mname)
            m.make_probs()
            store[idx] = m
