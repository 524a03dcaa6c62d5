"""Species parameter (.pbl) file compiler.

Parses the AUGUSTUS species parameter files (``*_igenic_probs.pbl``,
``*_exon_probs.pbl``, ``*_intron_probs.pbl``, ``*_utr_probs.pbl``) into
typed NumPy structures, one block per GC-content class.  Formats follow the
reference readers:

  * igenic: src/igenicmodel.cc readAllParameters ([P_ls], [EMISSION])
  * exon:   src/exonmodel.cc readAllParameters ([STARTCODONS]?, [LENGTH],
            per-class [P_ls] [TRANSINIT] [TRANSINITBIN]? [ETMOTIF0-2]
            [EMISSION] [INITEMISSION] [ETEMISSION])
  * intron: src/intronmodel.cc readAllParameters ([ASS] [ASSBIN]? [DSS]
            [DSSBIN]? [LENGTH], per-class [TRANSITION] [EMISSION] [ASSMOTIF])
  * UTR:    src/utrmodel.cc readAllParameters ([UTRLENGTH] [AATAAA], per-class
            emission tables, TSS/TATA/TTS motifs)

All probabilities are kept linear float64 here; log conversion happens in the
track builders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..constants import Constants

_ACGT = {"a": 0, "c": 1, "g": 2, "t": 3}


def pattern_index(tok: str) -> int:
    """Pattern string -> index; ignores non-acgt characters like the
    reference Seq2Int::read."""
    idx = 0
    for ch in tok.lower():
        v = _ACGT.get(ch)
        if v is not None:
            idx = (idx << 2) | v
    return idx


class TokenCursor:
    """Token stream over a .pbl file with '#'-comment stripping and
    section-tag search (the reference's goto_line_after)."""

    def __init__(self, path: str):
        toks: List[str] = []
        with open(path) as fh:
            for raw in fh:
                line = raw.split("#", 1)[0]
                toks.extend(line.split())
        self.toks = toks
        self.pos = 0

    def seek_after(self, tag: str) -> None:
        if not self.try_seek_after(tag):
            raise ValueError(f"section {tag} not found")

    def try_seek_after(self, tag: str) -> bool:
        for i in range(self.pos, len(self.toks)):
            if self.toks[i] == tag:
                self.pos = i + 1
                return True
        return False

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def next_int(self) -> int:
        return int(self.next())

    def next_float(self) -> float:
        return float(self.next())


@dataclass
class Motif:
    """Windowed weight-array matrix: per window position an order-k Markov
    emission table (reference src/motif.cc Motif::read/seqProb)."""
    n: int
    k: int
    window_probs: np.ndarray      # (n, 4^{k+1})

    @classmethod
    def read(cls, cur: TokenCursor) -> "Motif":
        n = cur.next_int()
        k = cur.next_int()
        size = 4 ** (k + 1)
        probs = np.zeros((n, size))
        for i in range(n):
            cur.next_int()   # window index
            for j in range(size):
                probs[i, j] = cur.next_float()
        return cls(n=n, k=k, window_probs=probs)


@dataclass
class BinnedProbs:
    """Piecewise-constant probability mapping (reference BinnedMMGroup)."""
    nbins: int = 0
    boundaries: np.ndarray = field(default_factory=lambda: np.zeros(0))
    avprobs: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @classmethod
    def read(cls, cur: TokenCursor) -> "BinnedProbs":
        nbins = cur.next_int()
        av = np.zeros(nbins)
        bb = np.zeros(max(nbins - 1, 0))
        av[0] = cur.next_float()
        for i in range(1, nbins):
            bb[i - 1] = cur.next_float()
            av[i] = cur.next_float()
        return cls(nbins=nbins, boundaries=bb, avprobs=av)

    def bin_of(self, p: np.ndarray) -> np.ndarray:
        """Index a with boundaries[a-1] <= p < boundaries[a]
        (reference BinnedMMGroup::getIndex binary search)."""
        return np.searchsorted(np.asarray(self.boundaries), p,
                                 side="right")

    def factor(self, p: np.ndarray) -> np.ndarray:
        if self.nbins == 0:
            return p
        return np.asarray(self.avprobs)[self.bin_of(p)]


# ---------------------------------------------------------------------------
# igenic
# ---------------------------------------------------------------------------

@dataclass
class IgenicGCParams:
    pls: List[np.ndarray]       # l -> (4^{l+1},)
    emiprobs: np.ndarray        # (4^{k+1},)


@dataclass
class IgenicParams:
    k: int
    gc: List[IgenicGCParams]


def read_igenic_pbl(path: str, num_classes: int) -> IgenicParams:
    cur = TokenCursor(path)
    k = 4
    gc: List[IgenicGCParams] = []
    for idx in range(num_classes):
        cur.seek_after(f"[{idx + 1}]")
        k = cur.next_int()
        cur.seek_after("[P_ls]")
        pls: List[np.ndarray] = []
        for l in range(k + 1):
            cur.next_int()   # l
            size = 4 ** (l + 1)
            vals = np.zeros(size)
            for j in range(size):
                pn = pattern_index(cur.next())
                vals[pn] = cur.next_float()
            pls.append(vals)
        emi = np.zeros(4 ** (k + 1))
        if cur.try_seek_after("[EMISSION]"):
            cur.next_int()   # size
            for j in range(emi.shape[0]):
                pn = pattern_index(cur.next())
                emi[pn] = cur.next_float()
        else:
            raise ValueError("igenic .pbl without [EMISSION] not supported yet")
        gc.append(IgenicGCParams(pls=pls, emiprobs=emi))
    return IgenicParams(k=k, gc=gc)


# ---------------------------------------------------------------------------
# exon
# ---------------------------------------------------------------------------

@dataclass
class ExonGCParams:
    pls: List[np.ndarray]           # l -> (3, 4^{l+1}) frame-major
    emiprobs: np.ndarray            # (3, 4^{k+1})
    initemiprobs: np.ndarray        # (3, 4^{k+1})
    etemiprobs: np.ndarray          # (3, 4^{k+1})
    trans_init_motif: Motif
    et_motif: List[Motif]
    tis_bin: BinnedProbs


@dataclass
class ExonParams:
    k: int
    exon_len_d: int
    num: Dict[str, int]
    num_huge: Dict[str, int]
    len_dist: Dict[str, np.ndarray]   # single/initial/internal/terminal
    gc: List[ExonGCParams]
    start_codon_probs: Optional[Dict[int, float]] = None


def _fill_length_tail(dist: np.ndarray, exon_len_d: int, num: int,
                      num_huge: int, max_len: int) -> None:
    """Geometric tail beyond the explicitly stored support
    (reference ExonModel::fillTailsOfLengthDistributions)."""
    a = dist[exon_len_d]
    p = 1.0 - a * (num + 1) / (num_huge + 1)
    for i in range(exon_len_d + 1, max_len + 1):
        dist[i] = p * dist[i - 1]


def read_exon_pbl(path: str, num_classes: int, cn: Constants,
                  k: int = 4) -> ExonParams:
    cur = TokenCursor(path)

    start_codon_probs = None
    if cur.try_seek_after("[STARTCODONS]"):
        n = cur.next_int()
        start_codon_probs = {}
        for _ in range(n):
            cod = cur.next()
            start_codon_probs[pattern_index(cod)] = cur.next_float()

    cur.seek_after("[LENGTH]")
    exon_len_d = cur.next_int()
    cur.next_float()            # slope_of_bandwidth
    cur.next_float()            # minwindowcount
    kinds = ("single", "initial", "internal", "terminal")
    num = {kind: int(float(cur.next())) for kind in kinds}
    num_huge = {kind: int(float(cur.next())) for kind in kinds}
    max_len = cn.max_exon_len
    dists = {kind: np.zeros(max_len + 1) for kind in kinds}
    for i in range(exon_len_d + 1):
        cur.next_int()   # length value
        for kind in kinds:
            dists[kind][i] = cur.next_float() / 1000.0
    dists["single"][: cn.min_coding_len] = 0.0
    for kind in kinds:
        _fill_length_tail(dists[kind], exon_len_d, num[kind], num_huge[kind],
                          max_len)

    gc: List[ExonGCParams] = []
    for idx in range(num_classes):
        cur.seek_after(f"[{idx + 1}]")
        cur.seek_after("[P_ls]")
        # the "# k = 4" line is a comment; the model order comes from the
        # /ExonModel/k property (reference exonmodel.cc readAllParameters)
        pls: List[np.ndarray] = []
        for l in range(k + 1):
            cur.next_int()   # l
            size = 4 ** (l + 1)
            vals = np.zeros((3, size))
            for j in range(size):
                pn = pattern_index(cur.next())
                vals[0, pn] = cur.next_float()
                vals[1, pn] = cur.next_float()
                vals[2, pn] = cur.next_float()
            pls.append(vals)

        cur.seek_after("[TRANSINIT]")
        tim = Motif.read(cur)
        save = cur.pos
        if cur.try_seek_after("[TRANSINITBIN]"):
            tis_bin = BinnedProbs.read(cur)
        else:
            cur.pos = save
            tis_bin = BinnedProbs()
        et = []
        for f in range(3):
            cur.seek_after(f"[ETMOTIF{f}]")
            et.append(Motif.read(cur))

        def read_3col(tag: str) -> np.ndarray:
            cur.seek_after(tag)
            size = cur.next_int()
            cur.next_int()      # k
            cur.next_float()    # patpseudocount
            out = np.zeros((3, size))
            for _ in range(size):
                pn = pattern_index(cur.next())
                out[0, pn] = cur.next_float()
                out[1, pn] = cur.next_float()
                out[2, pn] = cur.next_float()
            return out

        emi = read_3col("[EMISSION]")
        initemi = read_3col("[INITEMISSION]")
        etemi = read_3col("[ETEMISSION]")
        gc.append(ExonGCParams(pls=pls, emiprobs=emi, initemiprobs=initemi,
                               etemiprobs=etemi, trans_init_motif=tim,
                               et_motif=et, tis_bin=tis_bin))

    return ExonParams(k=k, exon_len_d=exon_len_d, num=num, num_huge=num_huge,
                      len_dist=dists, gc=gc,
                      start_codon_probs=start_codon_probs)


# ---------------------------------------------------------------------------
# intron
# ---------------------------------------------------------------------------

@dataclass
class IntronGCParams:
    prob_short_intron: float
    mal: float                     # mean additional length of long introns
    emiprobs: np.ndarray           # (4^{k+1},)
    ass_motif: Motif


@dataclass
class IntronParams:
    k: int
    d: int
    ass_probs: np.ndarray          # (4^{ass_size},)
    dss_probs: np.ndarray          # (4^{dss_size},)
    ass_bin: BinnedProbs
    dss_bin: BinnedProbs
    len_dist: np.ndarray           # (d+1,)
    c_ass: int = 0
    c_dss: int = 0
    ass_pseudo: float = 0.0
    dss_pseudo: float = 0.0
    non_ag_ass_prob: float = 0.0
    non_gt_dss_prob: float = 0.0
    gc: List[IntronGCParams] = field(default_factory=list)


def read_intron_pbl(path: str, num_classes: int, cn: Constants,
                    props=None) -> IntronParams:
    cur = TokenCursor(path)

    cur.seek_after("[ASS]")
    size = cur.next_int()
    c_ass = cur.next_int()
    ass_pseudo = cur.next_float()
    ass_probs = np.full(size, ass_pseudo / (c_ass + ass_pseudo * size))
    # sparse listing: pattern/value pairs until the next section tag
    while cur.peek() is not None and not cur.peek().startswith("["):
        pn = pattern_index(cur.next())
        ass_probs[pn] = cur.next_float() / 1000.0
    save = cur.pos
    ass_bin = BinnedProbs.read(cur) if cur.try_seek_after("[ASSBIN]") \
        else BinnedProbs()
    if ass_bin.nbins == 0:
        cur.pos = save

    cur.seek_after("[DSS]")
    size = cur.next_int()
    c_dss = cur.next_int()
    dss_pseudo = cur.next_float()
    dss_probs = np.zeros(size)
    for pn in range(size):
        check = pattern_index(cur.next())
        assert check == pn, "DSS patterns out of order"
        dss_probs[pn] = cur.next_float() / 1000.0
    save = cur.pos
    dss_bin = BinnedProbs.read(cur) if cur.try_seek_after("[DSSBIN]") \
        else BinnedProbs()
    if dss_bin.nbins == 0:
        cur.pos = save

    cur.seek_after("[LENGTH]")
    d = cur.next_int()
    len_dist = np.zeros(d + 1)
    for i in range(d + 1):
        len_dist[i] = cur.next_float() / 1000.0

    gc: List[IntronGCParams] = []
    k = 4
    for idx in range(num_classes):
        cur.seek_after(f"[{idx + 1}]")
        cur.seek_after("[TRANSITION]")
        prob_short = cur.next_float()
        mal = cur.next_float()
        cur.seek_after("[EMISSION]")
        size = cur.next_int()
        k = cur.next_int()
        cur.next_float()   # patpseudo
        emi = np.zeros(size)
        for _ in range(size):
            pn = pattern_index(cur.next())
            emi[pn] = cur.next_float()
        cur.seek_after("[ASSMOTIF]")
        motif = Motif.read(cur)
        gc.append(IntronGCParams(prob_short_intron=prob_short, mal=mal,
                                 emiprobs=emi, ass_motif=motif))

    # probability multiplied for non-GT (resp. non-AG) consensus sites
    # (reference intronmodel.cc: non_gt_dss_prob/non_ag_ass_prob properties)
    non_gt = 0.001
    non_ag = 0.001
    if props is not None:
        non_gt = props.get_float("/IntronModel/non_gt_dss_prob", non_gt)
        non_ag = props.get_float("/IntronModel/non_ag_ass_prob", non_ag)

    return IntronParams(k=k, d=d, ass_probs=ass_probs, dss_probs=dss_probs,
                        ass_bin=ass_bin, dss_bin=dss_bin, len_dist=len_dist,
                        c_ass=c_ass, c_dss=c_dss, ass_pseudo=ass_pseudo,
                        dss_pseudo=dss_pseudo, non_ag_ass_prob=non_ag,
                        non_gt_dss_prob=non_gt, gc=gc)


# ---------------------------------------------------------------------------
# UTR
# ---------------------------------------------------------------------------

@dataclass
class UtrGCParams:
    emi_5init: np.ndarray        # (4^{k+1},) mixed with intron emissions
    emi_5: np.ndarray
    emi_3: np.ndarray
    tssup: np.ndarray            # (4^{tssup_k+1},)
    tss_motif: Motif
    tss_motif_tata: Motif
    tata_motif: Motif
    tts_motif: Motif


@dataclass
class UtrParams:
    k: int
    tssup_k: int
    exon_len_d: int
    aataaa_probs: np.ndarray     # (4^boxlen,)
    aataaa_boxlen: int
    len_dist: Dict[str, np.ndarray]      # keys like "5single".."3term"
    tail_len_dist5: np.ndarray
    tail_len_dist3: np.ndarray
    gc: List[UtrGCParams] = field(default_factory=list)


def read_utr_pbl(path: str, num_classes: int, cn: Constants, props,
                 intron: IntronParams) -> UtrParams:
    """reference UtrModel::readAllParameters (src/utrmodel.cc:600-700).

    The 5'/3' content tables are mixed with the intron content model using
    utr5patternweight / utr3patternweight (src/utrmodel.cc:682-687)."""
    cur = TokenCursor(path)

    max_exon_length = props.get_int("/UtrModel/maxexonlength", 1500)
    max3single = props.get_int("/UtrModel/max3singlelength", 5500)
    max3term = props.get_int("/UtrModel/max3termlength", 3500)
    w5 = props.get_float("/UtrModel/utr5patternweight", 0.0)
    w3 = props.get_float("/UtrModel/utr3patternweight", 0.0)
    polyasig = props.get("/UtrModel/polyasig_consensus", "aataaa")
    boxlen = len(polyasig)

    cur.seek_after("[UTRLENGTH]")
    exon_len_d = cur.next_int()
    cur.next_float()   # slope_of_bandwidth
    cur.next_float()   # minwindowcount
    kinds = ("5single", "5initial", "5internal", "5terminal",
             "3single", "3initial", "3internal", "3terminal")
    num = {kk: int(float(cur.next())) for kk in kinds}
    num_huge = {kk: int(float(cur.next())) for kk in kinds}
    sizes = {"5single": max_exon_length, "5initial": max_exon_length,
             "5internal": max_exon_length, "5terminal": max_exon_length,
             "3single": max3single, "3initial": max_exon_length,
             "3internal": max_exon_length, "3terminal": max3term}
    dists = {kk: np.zeros(sizes[kk] + 1) for kk in kinds}
    for i in range(exon_len_d + 1):
        cur.next_int()
        for kk in kinds:
            dists[kk][i] = cur.next_float() / 1000.0
    for kk in kinds:
        _fill_length_tail(dists[kk], exon_len_d, num[kk], num_huge[kk],
                          sizes[kk])

    # tail length distributions for truncated single UTRs
    def tail_of(dist):
        total = dist.sum()
        out = np.zeros_like(dist)
        cumsum = 0.0
        for i in range(dist.shape[0] - 1, -1, -1):
            cumsum += dist[i]
            out[i] = cumsum / total if total > 0 else 0.0
        return out

    tail5 = tail_of(dists["5single"])
    tail3 = tail_of(dists["3single"])

    cur.seek_after("[AATAAA]")
    size = cur.next_int()
    aataaa = np.zeros(size)
    while cur.peek() is not None and not cur.peek().startswith("["):
        pn = pattern_index(cur.next())
        aataaa[pn] = cur.next_float()

    gc: List[UtrGCParams] = []
    k = props.get_int("/UtrModel/k", 4)
    tssup_k = props.get_int("/UtrModel/tssup_k", 0)
    for idx in range(num_classes):
        cur.seek_after(f"[{idx + 1}]")

        def emis(tag):
            cur.seek_after(tag)
            sz = cur.next_int()
            cur.next_int()     # k
            cur.next_float()   # patpseudo
            out = np.zeros(sz)
            for _ in range(sz):
                pn = pattern_index(cur.next())
                out[pn] = cur.next_float()
            return out

        e5i = emis("[EMISSION-5INITIAL]")
        e5 = emis("[EMISSION-5]")
        e3 = emis("[EMISSION-3]")
        # tssup table has its own header: size then values
        cur.seek_after("[EMISSION-TSSUPWIN]")
        sz = cur.next_int()
        cur.next_int()
        cur.next_float()
        tssup = np.zeros(sz)
        for _ in range(sz):
            pn = pattern_index(cur.next())
            tssup[pn] = cur.next_float()

        # mix with the intron content model (same GC class)
        iem = intron.gc[idx].emiprobs
        e5i = e5i * w5 + iem * (1.0 - w5)
        e5 = e5 * w5 + iem * (1.0 - w5)
        e3 = e3 * w3 + iem * (1.0 - w3)

        cur.seek_after("[TSSMOTIF]")
        tssm = Motif.read(cur)
        cur.seek_after("[TSSMOTIFTATA]")
        tssmt = Motif.read(cur)
        cur.seek_after("[TATAMOTIF]")
        tatam = Motif.read(cur)
        cur.seek_after("[TTSMOTIF]")
        ttsm = Motif.read(cur)
        gc.append(UtrGCParams(emi_5init=e5i, emi_5=e5, emi_3=e3, tssup=tssup,
                              tss_motif=tssm, tss_motif_tata=tssmt,
                              tata_motif=tatam, tts_motif=ttsm))

    return UtrParams(k=k, tssup_k=tssup_k, exon_len_d=exon_len_d,
                     aataaa_probs=aataaa, aataaa_boxlen=boxlen,
                     len_dist=dists, tail_len_dist5=tail5,
                     tail_len_dist3=tail3, gc=gc)
