"""Device-route track preparation: the JGold twin of GoldEngine.prepare.

Counterpart of `augustus_tpu/engine/jgold.py`.  The host route computes
every per-base table in numpy on one thread; JGold runs the same builders
(gold._prepare_tracks, device.build_tracks, scan.split_tracks,
pack.pack_tracks) on torch tensors on the card (xputil.use_torch), from

  * the code array (k-mer gathers, ordered float64 prefix sums),
  * the per-base GC-class stairs (host-computed),
  * sparse hint overlays (interval lists and point sets, built on the host
    from SeqHints in O(#hints) by `build_overlays`).

Scope, as in the reference: the no-UTR exon-model architecture without
exon/CDS-kind hints (exonpart, CDSpart, exon, CDS); such chunks take the
host route (predict._decode), and `build_hint_tables_device` raises.

Exactness.  The reference scatters interval weights as float32 diffs and
cumsums them; the port instead sums each run of bases with one set of
covering hints on the host, in the order the host route adds them (its
float64 weights from `build_overlays(..., np.float64)`), and expands the
runs on the card (`repeat_interleave`), so the hint tracks equal the host
route's bit for bit and no float scatter-add (whose order varies on CUDA)
is needed.  Point sets hold unique positions; out-of-range indices are
dropped as JAX's `mode="drop"` drops them (xputil.seta).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..constants import STARTCODON_LEN
from .gold import GoldEngine, NEG_INF
from . import xputil as U

# overlay interval kinds
IV_KINDS = ("ig_ir", "ig_nep", "ig_gen", "ipb_p", "ipb_m", "cov_p", "cov_m")
SITE_KINDS = ("dss_p", "dss_m", "ass_p", "ass_m")
CODON_KINDS = ("stop_p", "stop_m", "start_p", "start_m")

_MALUS_KEYS = ("start", "stop", "ass", "dss", "exonpart", "exon",
               "intronpart", "intron", "CDS", "CDSpart", "UTR", "UTRpart",
               "tss", "tts")


@dataclass(frozen=True)
class OverlayMeta:
    """Static part of the hint overlays (the reference's jit-cache key)."""
    has_hints: bool
    sparse_exon: bool
    sizes: Tuple[Tuple[str, int], ...]
    log_malus: Tuple[Tuple[str, float], ...]
    local_malus_cp: float
    ig_malus: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _bucket_len(m: int) -> int:
    """Pad sparse overlay arrays to power-of-two sizes."""
    v = 8
    while v < m:
        v *= 2
    return v


BIG = np.int32(1 << 30)


def build_overlays(seq_hints, n: int, fdtype=np.float32):
    """Host-side: SeqHints -> (OverlayMeta, dict of padded np arrays), equal
    to the reference's.  fdtype is the type of the weight and value arrays:
    the reference's float32, or float64 for the device route, which keeps
    the host route's values (reference igenicmodel.cc:318,
    extrinsicinfo.cc:1697-1818, exonmodel.cc:1294-1311)."""
    from ..hints.system import distance_faded_bonus
    h = seq_hints
    if h is None:
        return OverlayMeta(False, False, (), (), 0.0), {}
    LOG = np.log

    iv: Dict[str, List[Tuple[int, int, float]]] = {k: [] for k in IV_KINDS}
    for f in h.by_type["irpart"]:
        iv["ig_ir"].append((max(f.start, 0), min(f.end, n - 1),
                            float(LOG(f.bonus))))
    for f in h.by_type["nonexonpart"]:
        iv["ig_nep"].append((max(f.start, 0), min(f.end, n - 1),
                             float(LOG(f.bonus))))
    for f in h.by_type["genicpart"]:
        iv["ig_gen"].append((max(f.start, 0), min(f.end, n - 1),
                             float(LOG(f.bonus))))
    for f in h.by_type["intronpart"] + h.by_type["nonexonpart"]:
        if f.strand in ("+", "."):
            iv["ipb_p"].append((max(f.start, 0), min(f.end, n - 1),
                                float(LOG(f.bonus))))
        if f.strand in ("-", "."):
            iv["ipb_m"].append((max(f.start, 0), min(f.end, n - 1),
                                float(LOG(f.bonus))))
    for f in h.by_type["CDSpart"] + h.by_type["exonpart"]:
        if f.strand in ("+", "."):
            iv["cov_p"].append((max(f.start, 0), min(f.end, n - 1), 1.0))
        if f.strand in ("-", "."):
            iv["cov_m"].append((max(f.start, 0), min(f.end, n - 1), 1.0))

    # splice-site adjustment COO (gold.site_adj): total faded bonus at each
    # position covered by a dss/ass hint (replaces the per-position malus)
    site: Dict[str, Dict[int, float]] = {k: {} for k in SITE_KINDS}
    for kind, tname, strand in (("dss_p", "dss", "+"), ("dss_m", "dss", "-"),
                                ("ass_p", "ass", "+"), ("ass_m", "ass", "-")):
        d = site[kind]
        for f in h.by_type[tname]:
            if f.strand not in (strand, "."):
                continue
            for p in range(max(f.start, 0), min(f.end + 1, n)):
                d[p] = d.get(p, 0.0) + distance_faded_bonus(f, p)

    # codon overlay COO by codon START a (gold.codon_adj): positions where a
    # start/stop hint OVERLAPS the codon; value = sum of fades of hints
    # COVERING it (0 when only partial overlaps: suppresses the malus)
    codon: Dict[str, Dict[int, float]] = {k: {} for k in CODON_KINDS}
    for kind, tname, strand in (("stop_p", "stop", "+"),
                                ("stop_m", "stop", "-"),
                                ("start_p", "start", "+"),
                                ("start_m", "start", "-")):
        d = codon[kind]
        for f in h.by_type[tname]:
            if f.strand not in (strand, "."):
                continue
            for a in range(max(f.start - 2, 0), min(f.end + 1, n)):
                v = d.get(a, 0.0)
                if f.start <= a and f.end >= a + 2:
                    v += distance_faded_bonus(f, a + 1)
                d[a] = v

    arrays: Dict[str, np.ndarray] = {}
    sizes: List[Tuple[str, int]] = []

    def put_iv(kind):
        lst = iv[kind]
        L = _bucket_len(len(lst))
        s_ = np.full(L, BIG, dtype=np.int32)
        e_ = np.full(L, BIG, dtype=np.int32)
        w_ = np.zeros(L, dtype=fdtype)
        for i, (a, b, w) in enumerate(lst):
            if b < a:
                continue
            s_[i], e_[i], w_[i] = a, b, w
        arrays[f"{kind}_s"] = s_
        arrays[f"{kind}_e"] = e_
        arrays[f"{kind}_w"] = w_
        sizes.append((kind, L))

    def put_coo(prefix, d):
        items = sorted(d.items())
        L = _bucket_len(len(items))
        p_ = np.full(L, BIG, dtype=np.int32)
        v_ = np.zeros(L, dtype=fdtype)
        for i, (p, v) in enumerate(items):
            p_[i], v_[i] = p, v
        arrays[f"{prefix}_p"] = p_
        arrays[f"{prefix}_v"] = v_
        sizes.append((prefix, L))

    for k in IV_KINDS:
        put_iv(k)
    for k in SITE_KINDS:
        put_coo(f"site_{k}", site[k])
    for k in CODON_KINDS:
        put_coo(f"codon_{k}", codon[k])
    # hinted splice-site positions (SeqHints.hinted_*: boolean site masks)
    for k, attr in (("fD", "hinted_fD"), ("rD", "hinted_rD"),
                    ("fA", "hinted_fA"), ("rA", "hinted_rA")):
        pos = np.flatnonzero(np.asarray(getattr(h, attr)))
        L = _bucket_len(pos.shape[0])
        p_ = np.full(L, BIG, dtype=np.int32)
        p_[: pos.shape[0]] = pos
        arrays[f"hs_{k}_p"] = p_
        sizes.append((f"hs_{k}", L))

    sparse = any(h.by_type[t] for t in ("exonpart", "CDSpart", "exon", "CDS"))
    lm = tuple((t, float(LOG(h.cfg.malus(t)))) for t in _MALUS_KEYS)
    local_cp = float(LOG(h.cfg.info("CDSpart").local_malus))
    igm = (float(LOG(h.cfg.malus("irpart"))),
           float(LOG(h.cfg.malus("nonexonpart"))),
           float(LOG(h.cfg.malus("genicpart"))))
    meta = OverlayMeta(True, bool(sparse), tuple(sizes), lm, local_cp, igm)
    return meta, arrays


def interval_runs(ov, n: int, terms, maluses=()):
    """Host: a per-base track of interval sums as runs of equal value.

    terms: (kind, sign) in the host route's order (gold._build_hint_tracks
    adds the intervals of each kind in list order, `+=` for sign +1, `-=`
    for -1); maluses: (kind, sign, value) added at the bases no interval of
    `kind` covers (0.0 elsewhere), after the terms and in this order.
    Returns (lengths int64, values float64): the track is values[r]
    repeated lengths[r] times, each value summed in the host route's order,
    so the expanded track equals the host route's bit for bit."""
    ivs = []
    cuts = {0, n}
    for kind, _ in terms:
        for a, b in zip(ov[f"{kind}_s"], ov[f"{kind}_e"]):
            if a <= b and a < n:
                cuts.update((int(a), int(b) + 1))
    bounds = np.array(sorted(c for c in cuts if 0 <= c <= n), dtype=np.int64)
    vals = np.zeros(bounds.shape[0] - 1)
    covered = {}
    for kind, sign in terms:
        cov = np.zeros(vals.shape[0], dtype=bool)
        for a, b, w in zip(ov[f"{kind}_s"], ov[f"{kind}_e"],
                           ov[f"{kind}_w"]):
            if not (a <= b and a < n):
                continue
            lo = np.searchsorted(bounds, a)
            hi = np.searchsorted(bounds, min(int(b) + 1, n))
            if sign > 0:
                vals[lo:hi] += w
            else:
                vals[lo:hi] -= w
            cov[lo:hi] = True
        covered[kind] = cov
    for kind, sign, m in maluses:
        add = np.where(~covered[kind], m, 0.0)
        if sign > 0:
            vals += add
        else:
            vals -= add
    return np.diff(bounds), vals


class _StaticHints:
    """Stand-in for SeqHints inside the device builder: device.build_tracks
    asks only whether exon/CDS-kind hints are present, and chunks with
    such hints never take this route."""
    by_type = {t: [] for t in ("exonpart", "CDSpart", "exon", "CDS")}


class JGold(GoldEngine):
    """GoldEngine twin whose prepare() variant runs on torch tensors (call
    it inside xputil.use_torch)."""

    def device_prepare(self, codes, stairs, meta: OverlayMeta, ov) -> None:
        """codes: (n,) int64 tensor; stairs: (n,) int32 tensor; meta, ov:
        build_overlays(..., np.float64) of the chunk's SeqHints."""
        n = codes.shape[0]
        self.codes = codes
        self.n = n
        self._kmer_full = {}
        self._ht_cache = {}
        self.has_hints = meta.has_hints
        self._ov = ov
        self._meta = meta
        if meta.has_hints:
            if meta.sparse_exon:
                self.build_hint_tables_device(0)
            self.hints = _StaticHints()
            self.log_malus = dict(meta.log_malus)
            self.log_local_malus_cp = meta.local_malus_cp
            self._build_hint_tracks_device(n)
        else:
            self.hints = None
        self.stairs = stairs
        self._prepare_tracks(codes)

    # -- device hint tracks (gold._build_hint_tracks twin) ---------------
    def _build_hint_tracks_device(self, n: int) -> None:
        xp = U.A.xp
        ov = self._ov

        def expand(runs):
            lengths, vals = runs
            return xp.repeat(U.asarr(vals), U.asarr(lengths), axis=0)

        # igenic adjustment: bonuses inside covering hints, maluses where
        # no such hint covers the base (reference igenicmodel.cc:318-326)
        m_ir, m_nep, m_gen = self._meta.ig_malus
        self.ig_adjust = expand(interval_runs(
            ov, n, (("ig_ir", 1), ("ig_nep", 1), ("ig_gen", -1)),
            (("ig_ir", 1, m_ir), ("ig_nep", 1, m_nep),
             ("ig_gen", -1, m_gen))))
        self.ipb_plus = expand(interval_runs(ov, n, (("ipb_p", 1),)))
        self.ipb_minus = expand(interval_runs(ov, n, (("ipb_m", 1),)))
        # the coverage counts of exonpart/CDSpart hints (cumcov_cp_*) feed
        # only the sparse exon-hint tables: such chunks take the host route

        # hinted splice-site masks for build_splice_tracks
        def pmask(kind):
            return U.seta(xp.zeros(n, dtype=bool), ov[f"hs_{kind}_p"], True)

        self._hinted_override = (pmask("fD"), pmask("rD"), pmask("fA"),
                                 pmask("rA"))

    def _extra_cum_rows(self, zero) -> dict:
        """The intronpart-bonus cums ipb_plus_cum / ipb_minus_cum, summed in
        _prepare_tracks' one prefix sum with the content rows."""
        if not self.has_hints:
            return {}
        xp = U.A.xp
        return {"ipb_plus_cum": xp.concatenate([zero, self.ipb_plus]),
                "ipb_minus_cum": xp.concatenate([zero, self.ipb_minus])}

    # -- device signal hint folding (gold._apply_signal_hint_terms twin) --
    def _apply_signal_hint_terms(self) -> None:
        xp = U.A.xp
        ov, lm, n = self._ov, self.log_malus, self.n

        def codon_apply(track, kind, shift):
            live = track > NEG_INF
            adj = xp.where(live, lm[kind.split("_")[0]], 0.0)
            adj = U.seta(adj, ov[f"codon_{kind}_p"].astype(np.int64) + shift,
                         ov[f"codon_{kind}_v"])
            return xp.where(live, track + adj, track)

        tw = self.cn.trans_init_window
        self.end_stop_fwd = codon_apply(self.end_stop_fwd, "stop_p", 2)
        self.begin_rstop = codon_apply(self.begin_rstop, "stop_m", 0)
        for c in self.classes:
            self.tis_begin_fwd[c] = codon_apply(
                self.tis_begin_fwd[c], "start_p", 0)
            self.tis_end_rev[c] = codon_apply(
                self.tis_end_rev[c], "start_m", tw + STARTCODON_LEN - 1)

        def site_adj(kind, tname):
            return U.seta(xp.full(n, lm[tname], dtype=np.float64),
                          ov[f"site_{kind}_p"], ov[f"site_{kind}_v"])

        self.dss_site_adj_p = site_adj("dss_p", "dss")
        self.dss_site_adj_m = site_adj("dss_m", "dss")
        self.ass_site_adj_p = site_adj("ass_p", "ass")
        self.ass_site_adj_m = site_adj("ass_m", "ass")

    def build_hint_tables_device(self, gpad: int):
        raise NotImplementedError(
            "sparse exon-hint configs run on the host prep path")
