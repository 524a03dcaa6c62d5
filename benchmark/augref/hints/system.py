"""Per-sequence hint collection: grouping, conformance, queries, site masks.

reference: SequenceFeatureCollection (src/extrinsicinfo.cc) + HintGroup
relations (src/hints.cc:560-760).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics
from .config import ExtrinsicConfig, FEATURE_TYPES
from .features import Feature, HintGroup

SIGNAL_TYPES = {"start", "stop", "ass", "dss", "tss", "tts"}
# order index used by compatibleWith's wlg-swap (reference FeatureType enum)
TYPE_ORDER = {t: i for i, t in enumerate(
    ["start", "stop", "ass", "dss", "tss", "tts", "exonpart", "exon",
     "intronpart", "intron", "irpart", "CDS", "CDSpart", "UTR", "UTRpart",
     "nonexonpart", "genicpart"])}

GFF_TYPE_MAP = {
    "dss": "dss", "ass": "ass", "stop": "stop", "start": "start",
    "exonpart": "exonpart", "ep": "exonpart", "exon": "exon",
    "intronpart": "intronpart", "ip": "intronpart", "intron": "intron",
    "tss": "tss", "tts": "tts", "irpart": "irpart", "CDS": "CDS",
    "CDSpart": "CDSpart", "cp": "CDSpart", "UTR": "UTR",
    "UTRpart": "UTRpart", "up": "UTRpart", "nonexonpart": "nonexonpart",
    "nep": "nonexonpart", "nonirpart": "genicpart", "genicpart": "genicpart",
}


def parse_gff_hints(path: str, ext_cfg: ExtrinsicConfig,
                    igenic_geo: float = 0.9999,
                    intron_geo: Optional[float] = None,
                    pred_start: Optional[int] = None,
                    pred_end: Optional[int] = None
                    ) -> Dict[str, List[Feature]]:
    """GFF hints -> per-seqname feature lists (reference readGFFFile +
    Feature operator>>, src/hints.cc:75).

    pred_start/pred_end (1-based CLI values): hints are clipped to the
    prediction window and left-shifted (reference extrinsicinfo.cc:2239)."""
    ps = (pred_start - 1) if pred_start is not None else 0
    pe = (pred_end - 1) if pred_end is not None else 2**31 - 1
    if ps == pe and ps < 0:
        offset = ps + 1   # negative predictionStart: shift only
    else:
        if ps < 0:
            ps = 0
        offset = -ps
    out: Dict[str, List[Feature]] = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            cols = line.split("\t")
            if len(cols) < 9:
                continue
            seqname, _src2, ftype, start, end, score, strand, frame, attrs = \
                cols[:9]
            t = GFF_TYPE_MAP.get(ftype)
            if t is None:
                continue
            f = Feature(start=int(start) - 1, end=int(end) - 1, type=t,
                        strand=strand if strand in "+-" else ".",
                        score=float(score) if score not in (".", "") else 0.0)
            f.frame = int(frame) if frame in ("0", "1", "2") else -1

            def attr(keys):
                for key in keys:
                    pos = attrs.find(key)
                    if pos >= 0:
                        val = attrs[pos + len(key):]
                        stop_at = len(val)
                        for i, ch in enumerate(val):
                            if ch in "; ":
                                stop_at = i
                                break
                        return val[:stop_at]
                return None

            f.groupname = attr(["group=", "grp="]) or ""
            pri = attr(["priority=", "pri="])
            f.priority = int(pri) if pri else -1
            mult = attr(["mult="])
            f.mult = int(mult) if mult else 1
            src = attr(["source=", "src="])
            if src:
                # source key = leading alphabetic run
                key = ""
                for ch in src:
                    if ch.isalpha():
                        key += ch
                    else:
                        break
                f.source = key
            if not ((f.end >= ps and f.start <= pe) or ps < 0):
                continue
            f.start += offset
            f.end += offset
            set_bonus_malus(f, ext_cfg, igenic_geo, intron_geo)
            if f.bonus != 1.0:
                out.setdefault(seqname, []).append(f)
    return out


def set_bonus_malus(f: Feature, cfg: ExtrinsicConfig, igenic_geo: float,
                    intron_geo: Optional[float]) -> None:
    """reference FeatureCollection::setBonusMalus (extrinsicinfo.cc:2309)."""
    ti = cfg.info(f.type)
    if not ti.bonus < 0:
        f.bonus = ti.bonus * ti.gradequot(f.source, f.score)
        f.malus = ti.malus
        if f.type == "intron" and intron_geo is not None:
            length = f.end - f.start + 1
            f.bonus *= (igenic_geo / intron_geo) ** length
        if f.mult > 1:
            newbonus = f.bonus ** f.mult
            if newbonus > f.bonus * f.mult:
                newbonus = f.bonus * f.mult
            f.bonus = newbonus
    else:
        if f.score > 0:
            f.bonus = f.score


def _compatible(a: Feature, b: Feature) -> bool:
    """reference Feature::compatibleWith (hints.cc:573)."""
    fuzzy = 50
    term3_M, term5_M = 1000, 0
    if a.start > b.end or a.end < b.start:
        if a.type == "tss" and b.type == "tss" and a.strand == b.strand and \
                abs((a.end + a.start) - (b.end + b.start)) // 2 <= term5_M:
            return False
        if a.type == "tts" and b.type == "tts" and a.strand == b.strand and \
                abs((a.end + a.start) - (b.end + b.start)) // 2 <= term3_M:
            return False
        return True
    if (a.strand == "-" and b.strand == "+") or \
            (a.strand == "+" and b.strand == "-"):
        asig, bsig = a.type in SIGNAL_TYPES, b.type in SIGNAL_TYPES
        if asig and bsig:
            return True
        if asig and (a.start < b.start or a.end > b.end):
            return True
        if bsig and (a.start > b.start or a.end < b.end):
            return True
        return False
    if a.type == b.type:
        if a.start == b.start and a.end == b.end:
            return True
        if a.type in ("exon", "intron", "CDS", "UTR"):
            return False
        return True
    f1, f2 = (a, b) if TYPE_ORDER[a.type] <= TYPE_ORDER[b.type] else (b, a)
    t1, t2 = f1.type, f2.type
    strand = a.strand
    if t1 in ("start", "stop"):
        if t2 in ("intronpart", "intron", "irpart", "nonexonpart", "UTR",
                  "UTRpart") and f1.start >= f2.start and f1.end <= f2.end:
            return False
        if t2 in ("CDSpart", "CDS"):
            if f1.start > f2.start and f1.end < f2.end:
                return False
            if strand == "+" and ((t1 == "start" and f1.start > f2.start) or
                                  (t1 == "stop" and f1.end < f2.end)):
                return False
            if strand == "-" and ((t1 == "start" and f1.end < f2.end) or
                                  (t1 == "stop" and f1.start > f2.start)):
                return False
            if t2 == "CDS" and (f1.end < f2.start + 2 or
                                f1.start > f2.end - 2):
                return False
            return True
        return True
    if t1 in ("ass", "dss"):
        if t2 in ("irpart", "UTR", "UTRpart", "exonpart", "exon", "CDS",
                  "CDSpart") and f1.start >= f2.start and f1.end <= f2.end:
            return False
        if t2 in ("intron", "intronpart"):
            if f1.start > f2.start and f1.end < f2.end:
                return False
            if strand == "+" and ((t1 == "dss" and f1.start > f2.start) or
                                  (t1 == "ass" and f1.end < f2.end)):
                return False
            if strand == "-" and ((t1 == "dss" and f1.end < f2.end) or
                                  (t1 == "ass" and f1.start > f2.start)):
                return False
            return True
        return True
    if t1 in ("tss", "tts"):
        if t2 in ("irpart", "intron", "intronpart", "nonexonpart", "CDS",
                  "CDSpart") and f1.start >= f2.start and f1.end <= f2.end:
            return False
        if t2 in ("UTR", "UTRpart", "exon", "exonpart"):
            if f1.start > f2.start + fuzzy and f1.end < f2.end - fuzzy:
                return False
            if strand == "+" and (
                    (t1 == "tss" and f1.start > f2.start + fuzzy) or
                    (t1 == "tts" and f1.end < f2.end - fuzzy)):
                return False
            if strand == "-" and (
                    (t1 == "tss" and f1.end < f2.end - fuzzy) or
                    (t1 == "tts" and f1.start > f2.start + fuzzy)):
                return False
            return True
        return True
    if t1 == "exonpart":
        if t2 in ("intronpart", "intron", "irpart", "nonexonpart"):
            return False
        if t2 == "exon" and (f1.start < f2.start or f1.end > f2.end):
            return False
        if t2 == "UTR" and (f1.start < f2.start and f1.end > f2.end):
            return False
        return True
    if t1 == "exon":
        if t2 in ("intronpart", "intron", "irpart", "nonexonpart"):
            return False
        if t2 == "CDS" and not (f1.start <= f2.start and f1.end >= f2.end):
            return False
        if t2 == "CDSpart" and (f1.start > f2.start or f1.end < f2.end):
            return False
        if t2 == "UTR" and not (
                (f1.start == f2.start and f1.end >= f2.end) or
                (f1.end == f2.end and f1.start <= f2.end)):
            return False
        if t2 == "UTRpart" and (f1.start > f2.start or f1.end < f2.end):
            return False
        return True
    if t1 == "intronpart":
        if t2 == "intron" and (f1.start < f2.start or f1.end > f2.end):
            return False
        if t2 in ("irpart", "CDS", "CDSpart", "UTR", "UTRpart"):
            return False
        return True
    if t1 == "intron":
        if t2 in ("irpart", "CDS", "CDSpart", "UTR", "UTRpart"):
            return False
        return True
    if t1 == "irpart":
        return t2 == "nonexonpart"
    if t1 == "CDS":
        return t2 == "CDSpart" and f1.start <= f2.start and f1.end >= f2.end
    if t1 == "CDSpart":
        return False
    if t1 == "UTR":
        return t2 == "UTRpart" and f1.start <= f2.start and f1.end >= f2.end
    return False


def _weaker_than(a: Feature, b: Feature) -> Tuple[bool, bool]:
    """reference Feature::weakerThan; returns (weaker, strictly)."""
    strictly = False
    if b.end < a.start or b.start > a.end:
        return False, strictly
    if a.type == b.type and a.start == b.start and a.end == b.end:
        return True, strictly
    if a.start != b.start or a.end != b.end:
        strictly = True
    t, ot = a.type, b.type
    if t == ot and t in SIGNAL_TYPES and a.start <= b.start and \
            a.end >= b.end:
        return True, strictly
    contained = a.start >= b.start and a.end <= b.end
    if t == "exonpart" and ot in ("exon", "exonpart") and contained:
        return True, strictly
    if t == "intronpart" and ot in ("intron", "intronpart") and contained:
        return True, strictly
    if t == "irpart" and ot == "irpart" and contained:
        return True, strictly
    if t == "CDSpart" and ot in ("CDS", "CDSpart") and contained:
        return True, strictly
    if t == "UTRpart" and ot in ("UTR", "UTRpart") and contained:
        return True, strictly
    if t == "nonexonpart" and ot == "nonexonpart" and contained:
        return True, strictly
    if t == "genicpart" and ot != "irpart" and contained:
        return True, strictly
    return False, strictly


class SeqHints:
    """All hints for one sequence, grouped and conformance-rescaled."""

    def __init__(self, features: List[Feature], ext_cfg: ExtrinsicConfig,
                 codes: np.ndarray, rescale_boni: bool = True):
        self.cfg = ext_cfg
        self.n = codes.shape[0]
        self.by_type: Dict[str, List[Feature]] = {t: [] for t in FEATURE_TYPES}
        for f in features:
            self.by_type[f.type].append(f)
        for t in self.by_type:
            self.by_type[t].sort(key=lambda f: (f.start, f.end))

        self._make_groups()
        self._conformance()
        if rescale_boni:
            for flist in self.by_type.values():
                for f in flist:
                    if f.bonus > 0:
                        conf = (5.0 + f.num_supporting) / (
                            10.0 + f.num_supporting + f.num_contradicting)
                        f.bonus = math.exp(math.log(f.bonus) * 2 * conf)
        self._hinted_sites(codes)

    # ------------------------------------------------------------------
    def _make_groups(self) -> None:
        byname: Dict[str, HintGroup] = {}
        self.groups: List[HintGroup] = []
        for t in FEATURE_TYPES:
            for f in self.by_type[t]:
                f.num_supporting = 0
                f.num_contradicting = 0.0
                if f.groupname == "" or f.groupname not in byname:
                    g = HintGroup(hints=[f], name=f.groupname)
                    g.copynumber = 1
                    self.groups.append(g)
                    if f.groupname != "":
                        byname[f.groupname] = g
                else:
                    byname[f.groupname].hints.append(f)
        for g in self.groups:
            g.priority = max((h.priority for h in g.hints), default=-1)
        self.groups.sort(key=lambda g: (g.begin, g.end))
        # merge exactly equal groups into copynumber
        out: List[HintGroup] = []
        for g in self.groups:
            if out and _groups_equal(out[-1], g):
                out[-1].copynumber += 1
            else:
                out.append(g)
        self.groups = out

    def _conformance(self) -> None:
        gs = self.groups
        # begin/end are invariant during conformance (only the counters
        # mutate); hoist them out of the O(pairs) loop — the properties
        # recompute min/max over the hint list on every access
        begs = [g.begin for g in gs]
        ends = [g.end for g in gs]
        for i, g1 in enumerate(gs):
            # with itself (copynumber)
            for f in g1.hints:
                f.num_supporting += g1.copynumber - 1
            b1, e1 = begs[i], ends[i]
            for j in range(i + 1, len(gs)):
                if begs[j] > e1:
                    break
                g2 = gs[j]
                self._update_conf(g1, g2, b1, e1, begs[j], ends[j])
                self._update_conf(g2, g1, begs[j], ends[j], b1, e1)

    @staticmethod
    def _update_conf(g1: HintGroup, g2: HintGroup,
                     b1: int, e1: int, b2: int, e2: int) -> None:
        """reference HintGroup::updateFeatureConformance (hints.cc:660)."""
        if e1 < b2 or b1 > e2:
            return
        lowerpriority = (g2.priority < g1.priority and g2.priority >= 0)
        for f in g1.hints:
            supporting = False
            contradicting = False
            only_ep_confl = True
            fract = 1.0
            for of in g2.hints:
                if not lowerpriority and not _compatible(f, of):
                    contradicting = True
                    if f.type == "intron" and of.type in (
                            "exonpart", "CDSpart", "UTRpart"):
                        ilen = min(max(f.end - f.start + 1, 1), 2000)
                        eplen = min(of.end - of.start + 1, ilen)
                        fract = eplen / ilen
                    else:
                        only_ep_confl = False
                weaker, _ = _weaker_than(f, of)
                if weaker:
                    supporting = True
            if supporting and not contradicting:
                f.num_supporting += g2.copynumber
            elif contradicting:
                if not only_ep_confl:
                    fract = 1.0
                f.num_contradicting += fract * g2.copynumber

    # ------------------------------------------------------------------
    def _hinted_sites(self, codes: np.ndarray) -> None:
        """reference computeHintedSites (extrinsicinfo.cc:191): positions
        where splice sites are allowed because hints say so, provided the
        dinucleotide pattern is in the allowed set {gt,gc / ag}."""
        n = self.n
        A, C, G, T = genetics.A, genetics.C, genetics.G, genetics.T
        gt = np.zeros(n, dtype=bool)
        gc = np.zeros(n, dtype=bool)
        ag = np.zeros(n, dtype=bool)
        if n > 1:
            gt[:-1] = (codes[:-1] == G) & (codes[1:] == T)
            gc[:-1] = (codes[:-1] == G) & (codes[1:] == C)
            ag[:-1] = (codes[:-1] == A) & (codes[1:] == G)
        valid_dss_at = gt | gc               # pattern starting at pos
        valid_ass_at = ag
        # reverse-complement patterns starting at pos: 'ac'/'gc' for rdss,
        # 'ct' for rass
        ac = np.zeros(n, dtype=bool)
        ct = np.zeros(n, dtype=bool)
        if n > 1:
            ac[:-1] = (codes[:-1] == A) & (codes[1:] == C)
            ct[:-1] = (codes[:-1] == C) & (codes[1:] == T)
        valid_rdss_at = ac | gc
        valid_rass_at = ct

        fD = np.zeros(n, dtype=bool)   # forward DSS hinted at pos
        rD = np.zeros(n, dtype=bool)
        fA = np.zeros(n, dtype=bool)
        rA = np.zeros(n, dtype=bool)

        def plusish(f):
            return f.strand in ("+", ".")

        def minusish(f):
            return f.strand in ("-", ".")

        for f in self.by_type["dss"]:
            if plusish(f):
                for k in range(max(f.start, 0), min(f.end, n - 2) + 1):
                    if valid_dss_at[k]:
                        fD[k] = True
            if minusish(f):
                for k in range(max(f.start, 1), min(f.end, n - 1) + 1):
                    if valid_rdss_at[k - 1]:
                        rD[k] = True
        for f in self.by_type["ass"]:
            if plusish(f):
                for k in range(max(f.start, 1), min(f.end, n - 1) + 1):
                    if valid_ass_at[k - 1]:
                        fA[k] = True
            if minusish(f):
                for k in range(max(f.start, 0), min(f.end, n - 2) + 1):
                    if valid_rass_at[k]:
                        rA[k] = True
        for f in self.by_type["intron"]:
            if f.start >= 0 and f.end < n and f.end - f.start >= 3:
                pat_ok = valid_dss_at[f.start] and valid_ass_at[f.end - 1]
                rpat_ok = valid_rass_at[f.start] and valid_rdss_at[f.end - 1]
                if plusish(f) and pat_ok:
                    fD[f.start] = True
                    fA[f.end] = True
                if minusish(f) and rpat_ok:
                    rD[f.end] = True
                    rA[f.start] = True
        for tname in ("exon", "CDS", "UTR"):
            for f in self.by_type[tname]:
                if f.start > 1 and f.end < n - 2:
                    if plusish(f):
                        if valid_dss_at[f.end + 1]:
                            fD[f.end + 1] = True
                        if valid_ass_at[f.start - 2]:
                            fA[f.start - 1] = True
                    if minusish(f):
                        if valid_rdss_at[f.start - 2]:
                            rD[f.start - 1] = True
                        if valid_rass_at[f.end + 1]:
                            rA[f.end + 1] = True
        self.hinted_fD, self.hinted_rD = fD, rD
        self.hinted_fA, self.hinted_rA = fA, rA

    # ------------------------------------------------------------------
    # query helpers (strand: '+', '-', 'both')
    def _strand_ok(self, f: Feature, strand: str) -> bool:
        if strand == "both":
            return True
        return f.strand == strand or f.strand == "."

    def ovlping(self, types, a: int, b: int, strand: str) -> List[Feature]:
        if isinstance(types, str):
            types = [types]
        return [f for t in types for f in self.by_type[t]
                if not (f.end < a or f.start > b)
                and self._strand_ok(f, strand)]


def _groups_equal(a: HintGroup, b: HintGroup) -> bool:
    if len(a.hints) != len(b.hints) or a.begin != b.begin or a.end != b.end:
        return False
    for f1, f2 in zip(a.hints, b.hints):
        if (f1.type, f1.start, f1.end, f1.strand) != \
                (f2.type, f2.start, f2.end, f2.strand):
            return False
    return True


def distance_faded_bonus(f: Feature, pos: int) -> float:
    """log-space distance_faded_bonus (reference hints.cc:557)."""
    if pos < f.start or pos > f.end:
        return 0.0
    delta = abs(2.0 * (pos - (f.end + f.start) / 2.0) / (f.end - f.start + 1))
    return math.log(f.bonus) * (1 - delta)
