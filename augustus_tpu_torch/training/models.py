"""Per-model maximum-likelihood trainers (exon / intron / intergenic).

Behavioral equivalents of the reference buildModel implementations
(src/exontrain.cc, src/introntrain.cc, src/igenictrain.cc).  Counting is
vectorized with NumPy where integer-exact (k-mer histograms); probability
estimation and smoothing preserve the C++ accumulation order so .pbl outputs
are byte-identical.

Port of `augustus_tpu/training/models.py`: host numpy, no kernel.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from .. import genetics
from ..constants import (Constants, ASS_MIDDLE, DSS_MIDDLE, STARTCODON_LEN,
                         STOPCODON_LEN)
from ..properties import Properties
from .annotation import AnnoSeq, TGene
from .motif import Motif
from .probs import (compute_emi_from_pat, compute_lower_order_pats,
                    determine_short_patterns, make_probs_from_counts)
from .smooth import smooth_counts, scale_dbl_vector


def mod3(x: int) -> int:
    return x % 3 if x >= 0 else (x % 3 + 3) % 3


class ExonModelError(Exception):
    pass


class IntronModelError(Exception):
    pass


def _count_kmers_both(codes: np.ndarray, k: int, start: int, end: int,
                      counts: np.ndarray, weight: int) -> int:
    """Count forward and reverse-complement (k+1)-mers ENDING at positions
    start..end (reference IntronModel/IGenicModel::processSequence: pattern
    s2i(p-k) plus s2i.rc(p-k)); returns the number of bases counted * 2.

    Invalid-nucleotide windows are skipped and do not contribute.
    """
    n = codes.shape[0]
    lo = start - k     # window start positions
    hi = end - k
    if lo < 0:
        lo = 0     # reference would read out of bounds; clamp
    if hi > n - (k + 1):
        hi = n - (k + 1)
    if hi < lo:
        return 0
    ids = genetics.kmer_ids(codes[lo: hi + k + 1], k + 1)
    rids = genetics.rc_kmer_ids(codes[lo: hi + k + 1], k + 1)
    valid = ids >= 0
    nv = int(valid.sum())
    if nv:
        np.add.at(counts, ids[valid], weight)
        np.add.at(counts, rids[valid], weight)
    return 2 * weight * nv


class IGenicTrainer:
    """Intergenic content model (src/igenictrain.cc)."""

    def __init__(self, props: Properties, cn: Constants):
        self.props = props
        self.cn = cn
        self.k = props.get_int("/IGenicModel/k", 4)
        self.patpseudocount = props.get_float("/IGenicModel/patpseudocount",
                                              1.0)
        self.verbosity = props.get_int("/IGenicModel/verbosity", 0)
        self.gc_pls: List[list] = []
        self.gc_emiprobs: List[np.ndarray] = []

    def build(self, annoseqs: List[AnnoSeq]) -> None:
        k = self.k
        emicount = np.zeros(4 ** (k + 1), dtype=np.int64)
        gesbasen = 0
        igenic_winlen = 1000000
        for a in annoseqs:
            if not a.genes:
                continue
            g = a.genes[0]
            if not g.exons:
                continue
            codes = _codes(a)
            w = g.weight
            igenic_start = max(0, g.gene_begin() - igenic_winlen)
            gesbasen += _count_kmers_both(
                codes, k, igenic_start + k, g.gene_begin() - 1 - 20,
                emicount, w)
            for lst in (g.utr5introns, g.utr3introns):
                for (ib, ie) in lst:
                    gesbasen += _count_kmers_both(
                        codes, k,
                        ib + k + self.cn.dss_end + DSS_MIDDLE,
                        ie - self.cn.ass_start - ASS_MIDDLE
                        - self.cn.ass_upwindow_size,
                        emicount, w)
            igenic_end = min(g.gene_end() + igenic_winlen, a.length - 1)
            gesbasen += _count_kmers_both(
                codes, k, g.gene_end() + 1 + k, igenic_end, emicount, w)
        self.emicount = emicount
        pls_k = make_probs_from_counts(emicount, k, self.patpseudocount)
        self.pls = compute_lower_order_pats(pls_k, k)
        self.emiprobs = compute_emi_from_pat(pls_k, k)

    def store_gc(self, idx: int) -> None:
        while len(self.gc_pls) <= idx:
            self.gc_pls.append(None)
            self.gc_emiprobs.append(None)
        self.gc_pls[idx] = self.pls
        self.gc_emiprobs[idx] = self.emiprobs


class IntronTrainer:
    """Intron model: splice sites, branch-point motif, length distribution,
    content chain (src/introntrain.cc)."""

    def __init__(self, props: Properties, cn: Constants):
        self.props = props
        self.cn = cn
        self.k = props.get_int("/IntronModel/k", 4)
        self.patpseudo = props.get_float("/IntronModel/patpseudocount", 1.0)
        self.slope_of_bandwidth = props.get_float(
            "/IntronModel/slope_of_bandwidth", 0.1)
        self.minwindowcount = props.get_int("/IntronModel/minwindowcount", 0)
        self.asspseudo = props.get_float("/IntronModel/asspseudocount", 0.1)
        self.dsspseudo = props.get_float("/IntronModel/dsspseudocount", 0.1)
        self.dssneighborfactor = props.get_float(
            "/IntronModel/dssneighborfactor", 0.01)
        self.d = props.get_int("/IntronModel/d", 100)
        self.ass_motif_memory = props.get_int(
            "/IntronModel/ass_motif_memory", 3)
        self.ass_motif_radius = props.get_int(
            "/IntronModel/ass_motif_radius", 3)
        self.verbosity = props.get_int("/IntronModel/verbosity", 0)
        self.has_splice_sites = False
        self.asscount = np.zeros(4 ** cn.ass_size, dtype=np.int64)
        self.dsscount = np.zeros(4 ** cn.dss_size, dtype=np.int64)
        self.c_ass = 0
        self.c_dss = 0
        self.gc_emiprobs: List[np.ndarray] = []
        self.gc_ass_motif: List[Motif] = []
        self.gc_prob_short: List[float] = []
        self.gc_mal: List[float] = []

    def build(self, annoseqs: List[AnnoSeq]) -> None:
        cn = self.cn
        self.ass_motif = Motif(cn.ass_upwindow_size, self.ass_motif_memory,
                               2, self.ass_motif_radius)
        if not self.has_splice_sites:
            self.asscount[:] = 0
            self.dsscount[:] = 0
            self.c_ass = 0
            self.c_dss = 0
        self.emicount = np.zeros(4 ** (self.k + 1), dtype=np.int64)
        self.gesbasen = 0
        self._store_intron_lengths(annoseqs)
        self._build_len_dist(annoseqs)
        self._build_probabilities(annoseqs)

    # -- length distribution -------------------------------------------------
    def _store_intron_lengths(self, annoseqs: List[AnnoSeq]) -> None:
        self.introns = 0
        maxlen = 0
        for a in annoseqs:
            for g in a.genes:
                for (b, e) in g.introns:
                    if e - b + 1 > maxlen:
                        maxlen = e - b + 1
        self.intlencount = np.zeros(maxlen + 1, dtype=np.int64)
        for a in annoseqs:
            for g in a.genes:
                for (b, e) in g.introns:
                    self.intlencount[e - b + 1] += 1
                    self.introns += 1

    def _build_len_dist(self, annoseqs: List[AnnoSeq]) -> None:
        d = self.d
        prior = getattr(self, "len_dist", np.zeros(0)).shape[0] \
            if hasattr(self, "len_dist") else 0
        self.len_dist = smooth_counts(self.intlencount, self.minwindowcount,
                                      self.slope_of_bandwidth,
                                      result_size=d + 1, prior_size=prior)
        scale_dbl_vector(self.len_dist, 1.0)
        introns_d = 0
        for i in range(min(d + 1, self.intlencount.shape[0])):
            introns_d += int(self.intlencount[i])
        sum_of_long = 0
        for i in range(d + 1, self.intlencount.shape[0]):
            sum_of_long += int(self.intlencount[i]) * i
        self.introns_d = introns_d
        if sum_of_long > 0:
            # reference: integer division (src/introntrain.cc:492)
            self.mal = float(sum_of_long // (self.introns - introns_d) - d)
        else:
            self.mal = 10.0
        self.prob_short_intron = 1.0 / (1.0 + self.mal * self.len_dist[d])

    # -- splice sites & content ---------------------------------------------
    def _build_probabilities(self, annoseqs: List[AnnoSeq]) -> None:
        cn = self.cn
        k = self.k
        num_err = 0
        for a in annoseqs:
            g = a.genes[0] if a.genes else None
            if g is None or not g.exons:
                continue
            codes = _codes(a)
            w = g.weight
            self.gesbasen += _count_kmers_both(
                codes, k, k, g.gene_begin() - 1 - 20, self.emicount, w)
            for (ib, ie) in g.utr5introns:
                self.gesbasen += _count_kmers_both(
                    codes, k, ib + k + cn.dss_end + DSS_MIDDLE,
                    ie - cn.ass_start - ASS_MIDDLE - cn.ass_upwindow_size,
                    self.emicount, w)
            for (ib, ie) in g.introns:
                try:
                    self._process_dss(codes, ib - 1)
                    self._process_ass(codes, ie + 1, with_motif=True,
                                      weight=w)
                except IntronModelError as e:
                    num_err += 1
                    if self.verbosity and num_err <= 20:
                        print("Sequence %s:\n%s" % (g.seqname, e),
                              file=sys.stderr)
            for (ib, ie) in g.utr3introns:
                self.gesbasen += _count_kmers_both(
                    codes, k, ib + k + cn.dss_end + DSS_MIDDLE,
                    ie - cn.ass_start - ASS_MIDDLE - cn.ass_upwindow_size,
                    self.emicount, w)
            self.gesbasen += _count_kmers_both(
                codes, k, g.gene_end() + 1 + k, a.length - 1,
                self.emicount, w)

        patternprobs = make_probs_from_counts(self.emicount, k,
                                              self.patpseudo)
        self.emiprobs = compute_emi_from_pat(patternprobs, k)

        # optional extra splice-site file (/IntronModel/splicefile): not
        # configured for fresh species (new_species template comments it out)
        if "/IntronModel/splicefile" in self.props:
            self._read_splice_sites()

        # acceptor probabilities with pseudocounts (src/introntrain.cc:406)
        size_a = self.asscount.shape[0]
        together = float(self.c_ass) + size_a * self.asspseudo
        self.assprobs = np.zeros(size_a, dtype=np.float64)
        for i in range(size_a):
            self.assprobs[i] = (float(self.asscount[i]) + self.asspseudo) \
                / together
        self._make_dss_probs()
        self.ass_motif.make_probs()
        self.has_splice_sites = True

    def _process_dss(self, codes: np.ndarray, pos: int) -> None:
        """pos = last base of the preceding exon (src/introntrain.cc:263)."""
        cn = self.cn
        if self.has_splice_sites or pos < cn.dss_start + 1:
            return
        c1, c2 = int(codes[pos + 1]), int(codes[pos + 2])
        gt = (c1 == genetics.G and c2 == genetics.T)
        gc = (c1 == genetics.G and c2 == genetics.C)
        if not (gt or (cn.dss_gc_allowed and gc)):
            raise IntronModelError(
                "DSS error! Expected 'gt'%s, but found '%s' at position %d."
                % (" or 'gc'" if cn.dss_gc_allowed else "",
                   genetics.decode(codes[pos + 1: pos + 3]), pos + 1))
        win = np.concatenate([codes[pos - cn.dss_start + 1: pos + 1],
                              codes[pos + 3: pos + 3 + cn.dss_end]])
        if win.shape[0] == cn.dss_size and not (win == genetics.N).any():
            pn = 0
            for b in win:
                pn = (pn << 2) | int(b)
            self.dsscount[pn] += 1
            self.c_dss += 1

    def _process_ass(self, codes: np.ndarray, pos: int, with_motif: bool,
                     weight: int) -> None:
        """pos = first base of the following exon (src/introntrain.cc:218)."""
        cn = self.cn
        if with_motif and pos - ASS_MIDDLE - cn.ass_start \
                - cn.ass_upwindow_size >= self.ass_motif.k:
            self.ass_motif.add_sequence(
                codes, pos - ASS_MIDDLE - cn.ass_start - cn.ass_upwindow_size,
                weight)
        if self.has_splice_sites:
            return
        if not (int(codes[pos - 2]) == genetics.A
                and int(codes[pos - 1]) == genetics.G):
            raise IntronModelError(
                "ASS error! Expected 'ag' but found '%s' at position %d."
                % (genetics.decode(codes[pos - 2: pos]), pos - ASS_MIDDLE))
        win = np.concatenate([codes[pos - ASS_MIDDLE - cn.ass_start:
                                    pos - ASS_MIDDLE],
                              codes[pos: pos + cn.ass_end]])
        if win.shape[0] == cn.ass_size and not (win == genetics.N).any():
            pn = 0
            for b in win:
                pn = (pn << 2) | int(b)
            self.asscount[pn] += 1
            self.c_ass += 1

    def _read_splice_sites(self) -> None:
        """Optional [DSS-OFFSET]/[ASS-OFFSET] splice window file
        (src/introntrain.cc:170)."""
        import os
        fname = os.path.join(self.props.species_dir(),
                             self.props.get("/IntronModel/splicefile"))
        with_motif = self.props.get_bool("/IntronModel/sf_with_motif", False)
        if not os.path.exists(fname):
            print("Intronmodel: Couldn't open file %s" % fname,
                  file=sys.stderr)
            return
        dssoffset, assoffset = 39, 42
        with open(fname) as fh:
            lines = fh.read().split("\n")
        mode = None
        for i, line in enumerate(lines):
            if "[DSS-OFFSET]" in line:
                mode = "dss"
            elif "[ASS-OFFSET]" in line:
                mode = "ass"
            elif mode in ("dss", "ass") and line.strip() and \
                    not line.startswith("#"):
                if mode == "dss":
                    dssoffset = int(line.strip())
                else:
                    assoffset = int(line.strip())
                mode = None
            elif line.startswith("dss "):
                codes = genetics.encode(line[4:].strip())
                try:
                    self._process_dss(codes, dssoffset)
                except IntronModelError:
                    pass
            elif line.startswith("ass "):
                codes = genetics.encode(line[4:].strip())
                try:
                    self._process_ass(codes, assoffset, with_motif, 1)
                except IntronModelError:
                    pass

    def _make_dss_probs(self) -> None:
        """Donor probabilities with neighbor smearing
        (src/introntrain.cc:555)."""
        size = self.dsscount.shape[0]
        dss_len = self.cn.dss_size
        probs = np.zeros(size, dtype=np.float64)
        # i-loop adds count+pseudo to i, plus neighborfactor*(count+pseudo)
        # to every single-base variant (including i itself) at each position.
        # Order-exact replication is required only at output precision; the
        # contributions are formed identically here: first the base terms,
        # then the neighbor terms accumulated in (i, j, nn) order.
        nf = self.dssneighborfactor
        pseudo = self.dsspseudo
        for i in range(size):
            base = float(self.dsscount[i]) + pseudo
            probs[i] += base
            contrib = nf * base
            for j in range(dss_len):
                p4j = 1 << (2 * j)
                nj = (i % (p4j * 4)) // p4j
                for nn in range(4):
                    pn = i + (nn - nj) * p4j
                    probs[pn] += contrib
        normsum = 0.0
        for i in range(size):
            normsum += probs[i]
        for i in range(size):
            probs[i] = probs[i] / normsum
        self.dssprobs = probs

    def store_gc(self, idx: int) -> None:
        while len(self.gc_emiprobs) <= idx:
            self.gc_emiprobs.append(None)
            self.gc_ass_motif.append(None)
            self.gc_prob_short.append(None)
            self.gc_mal.append(None)
        self.gc_emiprobs[idx] = self.emiprobs
        self.gc_ass_motif[idx] = self.ass_motif
        self.gc_prob_short[idx] = self.prob_short_intron
        self.gc_mal[idx] = self.mal


class ExonTrainer:
    """Coding-exon model: frame-dependent content chains, TIS/et motifs,
    length distributions, stop-codon stats (src/exontrain.cc)."""

    def __init__(self, props: Properties, cn: Constants):
        self.props = props
        self.cn = cn
        self.k = props.get_int("/ExonModel/k", 4)
        self.patpseudo = props.get_float("/ExonModel/patpseudocount", 1.0)
        self.exon_len_d = props.get_int("/ExonModel/exonlengthD", 1000)
        self.slope_of_bandwidth = props.get_float(
            "/ExonModel/slope_of_bandwidth", 0.1)
        self.minwindowcount = props.get_int("/ExonModel/minwindowcount", 1)
        self.min_pat_sum = props.get_int("/ExonModel/minPatSum", 0)
        self.etorder = props.get_int("/ExonModel/etorder", 2)
        self.etpseudocount = props.get_int("/ExonModel/etpseudocount", 3)
        self.tis_motif_memory = props.get_int("/ExonModel/tis_motif_memory",
                                              3)
        self.tis_motif_radius = props.get_int("/ExonModel/tis_motif_radius",
                                              2)
        self.verbosity = props.get_int("/ExonModel/verbosity", 0)
        self.has_len_dist = False
        self.gc_pls: List[list] = []
        self.gc_emiprobs: List[list] = []
        self.gc_initemiprobs: List[list] = []
        self.gc_etemiprobs: List[list] = []
        self.gc_trans_init_motif: List[Motif] = []
        self.gc_et_motif: List[list] = []

    def build(self, annoseqs: List[AnnoSeq]) -> None:
        cn = self.cn
        k = self.k
        npat = 4 ** (k + 1)
        self.gesbasen = [0, 0, 0]
        self.patterncount = np.zeros((3, npat), dtype=np.int64)
        self.initpatterncount = np.zeros((3, npat), dtype=np.int64)
        self.etpatterncount = np.zeros((3, npat), dtype=np.int64)
        self.trans_init_motif = Motif(cn.trans_init_window,
                                      self.tis_motif_memory, 1,
                                      self.tis_motif_radius)
        self.et_motif = [Motif(cn.et_coding_len, self.etorder,
                               self.etpseudocount) for _ in range(3)]
        self.ochrecount = self.ambercount = self.opalcount = 0
        self.startcounts = np.zeros(64, dtype=np.int64)
        if not self.has_len_dist:
            self.len_count = {t: np.zeros(self.exon_len_d + 1, dtype=np.int64)
                              for t in ("single", "initial", "internal",
                                        "terminal")}
            self.num_of = {t: [0, 0, 0] if t in ("initial", "internal")
                           else 0 for t in ("single", "initial", "internal",
                                            "terminal")}
            self.num_huge_of = {t: [0, 0, 0] if t in ("initial", "internal")
                                else 0 for t in ("single", "initial",
                                                 "internal", "terminal")}
        for a in annoseqs:
            g = a.genes[0] if a.genes else None
            if g is None:
                continue
            self.gweight = g.weight
            if g.clength % 3 != 0:
                if self.verbosity:
                    print("gene %s transcr. %s in sequence %s: coding length"
                          " not a multiple of 3. Skipping..."
                          % (g.geneid, g.id, g.seqname), file=sys.stderr)
                continue
            if g.exons:
                codes = _codes(a)
                self._process_exons(codes, g)
        self._build_probabilities()

    # -- per-gene counting ---------------------------------------------------
    def _process_exons(self, codes: np.ndarray, g: TGene) -> None:
        self.curwin = 0
        exons = g.exons
        if len(exons) == 1:
            try:
                self._process_single(codes, exons[0])
            except ExonModelError as e:
                if self.verbosity:
                    print("gene %s transcr. %s in sequence %s: %s"
                          % (g.geneid, g.id, g.seqname, e), file=sys.stderr)
        else:
            try:
                self._process_initial(codes, exons[0])
            except ExonModelError as e:
                if self.verbosity:
                    print("gene %s transcr. %s in sequence %s: %s"
                          % (g.geneid, g.id, g.seqname, e), file=sys.stderr)
            for exon in exons[1:-1]:
                try:
                    self._process_internal(codes, exon)
                except ExonModelError as e:
                    if self.verbosity:
                        print("gene %s transcr. %s in sequence %s: %s"
                              % (g.geneid, g.id, g.seqname, e),
                              file=sys.stderr)
            try:
                self._process_terminal(codes, exons[-1])
            except ExonModelError as e:
                if self.verbosity:
                    print("gene %s transcr. %s in sequence %s: %s"
                          % (g.geneid, g.id, g.seqname, e), file=sys.stderr)

    def _is_start(self, codes: np.ndarray, pos: int) -> bool:
        return (pos + 3 <= codes.shape[0]
                and int(codes[pos]) == genetics.A
                and int(codes[pos + 1]) == genetics.T
                and int(codes[pos + 2]) == genetics.G)

    def _count_start(self, codes: np.ndarray, pos: int) -> None:
        pn = (int(codes[pos]) << 4) | (int(codes[pos + 1]) << 2) \
            | int(codes[pos + 2])
        self.startcounts[pn] += 1

    def _stop_kind(self, codes: np.ndarray, pos: int) -> Optional[str]:
        tri = tuple(int(x) for x in codes[pos: pos + 3])
        return {(3, 0, 0): "ochre", (3, 0, 2): "amber",
                (3, 2, 0): "opal"}.get(tri)

    def _add_tis(self, codes: np.ndarray, exon_begin: int, length: int
                 ) -> None:
        cn = self.cn
        if length > cn.trans_init_window and \
                exon_begin >= cn.trans_init_window + self.tis_motif_memory:
            self.trans_init_motif.add_sequence(
                codes, exon_begin - cn.trans_init_window, self.gweight)

    def _process_single(self, codes: np.ndarray, exon) -> None:
        b, e = exon
        length = e - b + 1
        if length < STARTCODON_LEN + STOPCODON_LEN:
            raise ExonModelError("Single training exon too short.")
        if not self._is_start(codes, b):
            raise ExonModelError(
                "Single exon gene does not begin with start codon but with "
                + genetics.decode(codes[b: b + 3]))
        self._count_start(codes, b)
        self._add_tis(codes, b, length)
        self.curwin = STARTCODON_LEN + self.k
        begin_inner = b + STARTCODON_LEN + self.k
        end_inner = e - STOPCODON_LEN
        end_init = begin_inner + self.cn.init_coding_len - 1
        self._process_inner(codes, begin_inner, end_init, 2)
        self._process_inner(codes, end_init + 1, end_inner, 0)
        kind = self._stop_kind(codes, e - STOPCODON_LEN + 1)
        if kind is None:
            raise ExonModelError("Single exon doesn't end in stop codon. "
                                 "Variable stopCodonExcludedFromCDS set "
                                 "right?")
        setattr(self, kind + "count", getattr(self, kind + "count") + 1)
        if not self.has_len_dist:
            if length <= self.exon_len_d:
                self.len_count["single"][length] += 1
            else:
                self.num_huge_of["single"] += 1
            self.num_of["single"] += 1

    def _process_initial(self, codes: np.ndarray, exon) -> None:
        cn = self.cn
        b, e = exon
        oldwin = self.curwin
        length = e - b + 1
        if length < STARTCODON_LEN:
            self.curwin = self.curwin + length
            raise ExonModelError("Initial exon has length < 3!")
        if not self._is_start(codes, b):
            self.curwin = self.curwin + length
            raise ExonModelError(
                "Initial exon does not begin with start codon but with "
                + genetics.decode(codes[b: b + 3]))
        self._count_start(codes, b)
        self._add_tis(codes, b, length)
        if e - cn.dss_start - cn.et_coding_len + 1 >= 0:
            self.et_motif[mod3(oldwin + length - cn.dss_start
                               - cn.et_coding_len)].add_sequence(
                codes, e - cn.dss_start - cn.et_coding_len + 1,
                self.gweight, reverse=True)
        self.curwin = self.curwin + STARTCODON_LEN + self.k
        try:
            begin_inner = b + STARTCODON_LEN + self.k
            end_inner = e - cn.dss_start
            end_init = begin_inner + cn.init_coding_len - 1
            if end_init > end_inner:
                end_init = end_inner
            self._process_inner(codes, begin_inner, end_init, 2)
            self._process_inner(codes, end_init + 1, end_inner, 0)
        except ExonModelError as err:
            print("ExonModel::processInitialExon: %s" % err, file=sys.stderr)
            raise
        self.curwin = oldwin + length
        if not self.has_len_dist:
            if length <= self.exon_len_d:
                self.len_count["initial"][length] += 1
            else:
                self.num_huge_of["initial"][mod3(self.curwin)] += 1
            self.num_of["initial"][mod3(self.curwin)] += 1

    def _process_internal(self, codes: np.ndarray, exon) -> None:
        cn = self.cn
        b, e = exon
        oldwin = self.curwin
        length = e - b + 1
        self.curwin = self.curwin + cn.ass_end + self.k
        try:
            begin_inner = b + cn.ass_end + self.k
            end_inner = e - cn.dss_start
            begin_et = end_inner - cn.et_coding_len + 1
            if begin_et < begin_inner:
                begin_et = begin_inner
            self._process_inner(codes, begin_inner, begin_et - 1, 0)
            self._process_inner(codes, begin_et, end_inner, 3)
            self.et_motif[mod3(oldwin + length - cn.dss_start
                               - cn.et_coding_len)].add_sequence(
                codes, e - cn.dss_start - cn.et_coding_len + 1,
                self.gweight, reverse=True)
        except ExonModelError as err:
            print("ExonModel::processInternalExon: %s" % err,
                  file=sys.stderr)
            raise
        self.curwin = oldwin + length
        if not self.has_len_dist:
            if length <= self.exon_len_d:
                self.len_count["internal"][length] += 1
            else:
                self.num_huge_of["internal"][mod3(self.curwin)] += 1
            self.num_of["internal"][mod3(self.curwin)] += 1

    def _process_terminal(self, codes: np.ndarray, exon) -> None:
        cn = self.cn
        b, e = exon
        length = e - b + 1
        self.curwin = self.curwin + cn.ass_end + self.k
        begin_inner = b + cn.ass_end + self.k
        end_inner = e - STOPCODON_LEN
        self._process_inner(codes, begin_inner, end_inner, 0)
        kind = self._stop_kind(codes, e - STOPCODON_LEN + 1)
        if kind is None:
            raise ExonModelError("Terminal exon doesn't end in stop codon. "
                                 "Variable stopCodonExcludedFromCDS set "
                                 "right?")
        setattr(self, kind + "count", getattr(self, kind + "count") + 1)
        if not self.has_len_dist:
            if length <= self.exon_len_d:
                self.len_count["terminal"][length] += 1
            else:
                self.num_huge_of["terminal"] += 1
            self.num_of["terminal"] += 1

    def _process_inner(self, codes: np.ndarray, begin: int, end: int,
                       modeltype: int) -> None:
        """Count frame-tagged (k+1)-mers ending at each position in
        [begin, end] (reference processInnerSequence, src/exontrain.cc:873).
        Aborts at an in-frame stop codon, keeping the counts so far."""
        if begin > end:
            return
        k = self.k
        target = (self.patterncount if modeltype == 0 else
                  self.initpatterncount if modeltype == 2 else
                  self.etpatterncount)
        n = codes.shape[0]
        curwin = self.curwin
        stop_at = None
        # frame of position p: (curwin + p - begin) % 3
        npos = end - begin + 1
        frames = (curwin % 3 + np.arange(npos)) % 3
        # in-frame stop scan: frame==0, end-p>=3, stop codon at p
        f0 = np.flatnonzero(frames == 0)
        for rel in f0:
            p = begin + rel
            if end - p >= STOPCODON_LEN and p + 3 <= n:
                tri = (int(codes[p]), int(codes[p + 1]), int(codes[p + 2]))
                if tri in ((3, 0, 0), (3, 0, 2), (3, 2, 0)):
                    stop_at = rel
                    break
        count_to = stop_at if stop_at is not None else npos
        if count_to > 0:
            pos = np.arange(begin, begin + count_to)
            starts = pos - k
            ok = (starts >= 0) & (pos <= n - 1)
            ids = np.full(count_to, -1, dtype=np.int64)
            if ok.any():
                smin = int(starts[ok][0])
                smax = int(pos[ok][-1])
                allids = genetics.kmer_ids(codes[smin: smax + 1], k + 1)
                ids[ok] = allids[starts[ok] - smin]
            valid = ids >= 0
            fr = frames[:count_to]
            for f in range(3):
                sel = valid & (fr == f)
                if sel.any():
                    np.add.at(target[f], ids[sel], self.gweight)
                    self.gesbasen[f] += self.gweight * int(sel.sum())
        if stop_at is not None:
            self.curwin = int(frames[stop_at])
            raise ExonModelError("in-frame stop codon")
        self.curwin = curwin + npos

    # -- probabilities -------------------------------------------------------
    def _build_probabilities(self) -> None:
        k = self.k
        self.trans_init_motif.make_probs()
        # start codon relative frequencies (GeneticCode::trainStartCodonProbs)
        ssum = int(self.startcounts.sum())
        self.start_codon_probs = {}
        if ssum > 0:
            atg = (0 << 4) | (3 << 2) | 2
            self.start_codon_probs[atg] = float(self.startcounts[atg]) / ssum
        else:
            self.start_codon_probs[(0 << 4) | (3 << 2) | 2] = 1.0
        for m in self.et_motif:
            m.make_probs()

        self.pls = [[None, None, None] for _ in range(k + 1)]
        shortpat = None
        for f in range(3):
            if self.min_pat_sum > 0:
                shortpat = determine_short_patterns(self.patterncount[f], k,
                                                    self.min_pat_sum)
                self.pls[k][f] = make_probs_from_counts(
                    self.patterncount[f], k, self.patpseudo, shortpat)
            else:
                self.pls[k][f] = make_probs_from_counts(
                    self.patterncount[f], k, self.patpseudo)
        self.initemiprobs = [None, None, None]
        for f in range(3):
            if self.min_pat_sum > 0:
                shortpat = determine_short_patterns(self.initpatterncount[f],
                                                    k, self.min_pat_sum)
                tmp = make_probs_from_counts(self.initpatterncount[f], k,
                                             self.patpseudo, shortpat)
            else:
                tmp = make_probs_from_counts(self.initpatterncount[f], k,
                                             self.patpseudo)
            self.initemiprobs[f] = compute_emi_from_pat(tmp, k)
        self.etemiprobs = [None, None, None]
        for f in range(3):
            if self.min_pat_sum > 0:
                shortpat = determine_short_patterns(self.etpatterncount[f],
                                                    k, self.min_pat_sum)
                tmp = make_probs_from_counts(self.etpatterncount[f], k,
                                             self.patpseudo, shortpat)
            else:
                tmp = make_probs_from_counts(self.etpatterncount[f], k,
                                             self.patpseudo)
            self.etemiprobs[f] = compute_emi_from_pat(tmp, k)

        # lower-order patterns (computeLowerOrderPats): per frame
        for f in range(3):
            col = compute_lower_order_pats(self.pls[k][f], k)
            for i in range(k + 1):
                self.pls[i][f] = col[i]

        self.emiprobs = [compute_emi_from_pat(self.pls[k][f], k)
                         for f in range(3)]
        if not self.has_len_dist:
            self._compute_length_distributions()
        self.has_len_dist = True

    def _compute_length_distributions(self) -> None:
        cn = self.cn
        maxlen = cn.max_exon_len
        self.num_single = int(self.num_of["single"])
        self.num_initial = sum(self.num_of["initial"])
        self.num_internal = sum(self.num_of["internal"])
        self.num_terminal = int(self.num_of["terminal"])
        self.num_huge_single = int(self.num_huge_of["single"])
        self.num_huge_initial = sum(self.num_huge_of["initial"])
        self.num_huge_internal = sum(self.num_huge_of["internal"])
        self.num_huge_terminal = int(self.num_huge_of["terminal"])

        dists = {}
        for t in ("single", "initial", "internal", "terminal"):
            dists[t] = smooth_counts(self.len_count[t], self.minwindowcount,
                                     self.slope_of_bandwidth,
                                     prior_size=maxlen + 1)
        # single exons shorter than the min coding length are impossible
        for i in range(min(cn.min_coding_len, dists["single"].shape[0])):
            dists["single"][i] = 0.0
        scale_dbl_vector(dists["single"],
                         float(self.num_single - self.num_huge_single)
                         / self.num_single if self.num_single else 0.0)
        scale_dbl_vector(dists["initial"],
                         float(self.num_initial - self.num_huge_initial)
                         / self.num_initial if self.num_initial else 0.0)
        scale_dbl_vector(dists["internal"],
                         float(self.num_internal - self.num_huge_internal)
                         / self.num_internal if self.num_internal else 0.0)
        scale_dbl_vector(dists["terminal"],
                         float(self.num_terminal - self.num_huge_terminal)
                         / self.num_terminal if self.num_terminal else 0.0)
        self.len_dist = dists
        self._fill_tails()

    def _fill_tails(self) -> None:
        """Geometric tails beyond exonLenD (ExonModel::
        fillTailsOfLengthDistributions, src/exonmodel.cc:833)."""
        d = self.exon_len_d
        maxlen = self.cn.max_exon_len
        for t, num, huge in (
                ("single", self.num_single, self.num_huge_single),
                ("initial", self.num_initial, self.num_huge_initial),
                ("internal", self.num_internal, self.num_huge_internal),
                ("terminal", self.num_terminal, self.num_huge_terminal)):
            v = self.len_dist[t]
            a = float(v[d])
            p = 1.0 - a / ((float(huge) + 1) / (num + 1))
            for i in range(d + 1, maxlen + 1):
                v[i] = p * v[i - 1]

    def store_gc(self, idx: int) -> None:
        while len(self.gc_pls) <= idx:
            for lst in (self.gc_pls, self.gc_emiprobs, self.gc_initemiprobs,
                        self.gc_etemiprobs, self.gc_trans_init_motif,
                        self.gc_et_motif):
                lst.append(None)
        self.gc_pls[idx] = self.pls
        self.gc_emiprobs[idx] = self.emiprobs
        self.gc_initemiprobs[idx] = self.initemiprobs
        self.gc_etemiprobs[idx] = self.etemiprobs
        self.gc_trans_init_motif[idx] = self.trans_init_motif
        self.gc_et_motif[idx] = list(self.et_motif)


def _codes(a: AnnoSeq) -> np.ndarray:
    if not hasattr(a, "_codes"):
        a._codes = genetics.encode(a.sequence)
    return a._codes
