"""Track preparation for the semi-Markov decode, and the sampling walk.

Counterpart of `augustus_tpu/engine/gold.py` less its float64 host DP
(`run`, `traceback`): the decode runs in engine/viterbi.py.
`GoldEngine.prepare`, `_prepare_tracks`, `_build_hint_tracks`,
`_apply_signal_hint_terms` and `set_boundaries` build float64 tracks of ORF
barriers, splice scores, content cumsums, signal sensors and the hint
bonus/malus terms of softmasking and hints files, which engine/device.py
factorizes into the DP tracks.  `prepare` is the host route (numpy);
`_prepare_tracks` and the track builders under it also run on torch
tensors for the device route (engine/jgold.py, xputil.use_torch).

`sample_path` draws a path from a forward table `.f` (engine/forward.py)
by the reference's ancestral sampling: for the state at hand it enumerates
the candidates (`_state_cands`: predecessor state and end of the previous
segment, in the reference's iteration order) over the host tracks of
`prepare` and draws one with the glibc rand() stream of crand.py.  Host
numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics
from ..constants import (Constants, ASS_MIDDLE, DSS_MIDDLE, STARTCODON_LEN,
                         STOPCODON_LEN)
from ..model.state_config import (ST, StateGraph, STATE_READING_FRAMES,
                                  is_on_f_strand)
from ..model.pbl import ExonParams, IgenicParams, IntronParams
from ..model import gc as gcmod
from . import tracks as T

NEG_INF = float("-inf")
LOG4 = float(np.log(4.0))


def mod3(x):
    return np.mod(x, 3)


def _log_bin(tb, p):
    """log(tb.factor(p)): the binned TIS probability of per-base p.  On
    tensors the bin is found on the device and its log gathered from the
    host's log of the bin averages (the same numpy log of the same
    values)."""
    from . import xputil as U
    if U.A.is_torch:
        return U.asarr(T._safe_log_np(np.asarray(tb.avprobs)))[
            U.A.xp.searchsorted(np.asarray(tb.boundaries), p, side="right")]
    return T._safe_log(tb.factor(p))


@dataclass
class ExonGeometry:
    """Per-exon-type fixed offsets (reference exonmodel.cc:230-280)."""
    etype: ST
    win: int
    begin_part_len: int
    inner_part_offset: int
    base_offset: int
    inner_part_end_offset: int
    forward: bool


def exon_geometry(etype: ST, cn: Constants) -> ExonGeometry:
    fwd = is_on_f_strand(etype)
    win = int(STATE_READING_FRAMES[etype])
    if etype in (ST.singleG, ST.initial0, ST.initial1, ST.initial2):
        bpl = STARTCODON_LEN + cn.trans_init_window
        ipo = STARTCODON_LEN
    elif etype in (ST.rsingleG, ST.rterminal0, ST.rterminal1, ST.rterminal2):
        bpl = ipo = STOPCODON_LEN
    else:
        bpl = 0
        ipo = cn.ass_end if fwd else cn.dss_start
    if etype in (ST.singleG, ST.terminal):
        bo, ipeo = 0, STOPCODON_LEN
    elif etype in (ST.rsingleG, ST.rinitial):
        bo, ipeo = -cn.trans_init_window, STARTCODON_LEN
    else:
        bo = cn.dss_start if fwd else cn.ass_end
        ipeo = cn.dss_start if fwd else cn.ass_end
    return ExonGeometry(etype=etype, win=win, begin_part_len=bpl,
                        inner_part_offset=ipo, base_offset=bo,
                        inner_part_end_offset=ipeo, forward=fwd)


class GoldEngine:
    """Track preparation for one sequence chunk with a fixed parameter
    set (the name is kept from augustus_tpu for the reader)."""

    def __init__(self, sg: StateGraph, cn: Constants,
                 igp: IgenicParams, exp: ExonParams, inp: IntronParams,
                 decomp: gcmod.Decomposition,
                 gcode: Optional[genetics.GeneticCode] = None,
                 ext_cfg=None):
        self.sg = sg
        self.cn = cn
        self.igp = igp
        self.exp = exp
        self.inp = inp
        self.decomp = decomp
        self.gcode = gcode or genetics.GeneticCode()
        self.ext_cfg = ext_cfg      # ExtrinsicConfig or None
        self.S = sg.statecount

        # per-GC-class adjusted transition matrices (log space).
        # reference IntronModel::updateToLocalGC modifies the global matrix:
        # columns into lessD states become probShortIntron, into equalD
        # 1-probShortIntron; geometric self-loops become 1-1/mal with the rest
        # of the row renormalized to total 1/mal (src/intronmodel.cc:440-488).
        self.log_trans: List[np.ndarray] = []
        for c in range(len(inp.gc)):
            tr = sg.transitions.copy()
            psi = inp.gc[c].prob_short_intron
            mal = inp.gc[c].mal
            for cur, t in enumerate(sg.state_types):
                if t in (ST.lessD0, ST.lessD1, ST.lessD2,
                         ST.rlessD0, ST.rlessD1, ST.rlessD2):
                    tr[:, cur][tr[:, cur] > 0] = psi
                elif t in (ST.equalD0, ST.equalD1, ST.equalD2,
                           ST.requalD0, ST.requalD1, ST.requalD2):
                    tr[:, cur][tr[:, cur] > 0] = 1.0 - psi
            for cur, t in enumerate(sg.state_types):
                if t in (ST.geometric0, ST.geometric1, ST.geometric2,
                         ST.rgeometric0, ST.rgeometric1, ST.rgeometric2):
                    if mal > 0:
                        row = tr[cur].copy()
                        others = row.sum() - row[cur]
                        tr[cur, cur] = 1.0 - 1.0 / mal
                        if others > 0:
                            scale = 1.0 / (mal * others)
                            for i in range(self.S):
                                if i != cur:
                                    tr[cur, i] = row[i] * scale
            with np.errstate(divide="ignore"):
                self.log_trans.append(np.log(tr))

        with np.errstate(divide="ignore"):
            self.log_init = np.log(sg.init_probs)
            self.log_term = np.log(sg.term_probs)

        # group state indices by type for quick access
        self.idx: Dict[ST, int] = dict(sg.type_to_index)
        self.exon_states = [(i, t) for i, t in enumerate(sg.state_types)
                            if sg.model_class[i] == "exonmodel"]
        self.geom = {t: exon_geometry(t, cn) for _, t in self.exon_states}

        # ancestors per state: indices i with trans[i][s] > 0, ascending
        self.ancestors: List[np.ndarray] = [
            np.flatnonzero(sg.transitions[:, s] > 0) for s in range(self.S)]

        d = inp.d
        self.d_state_len = (d - DSS_MIDDLE - cn.dss_end - cn.ass_start
                            - ASS_MIDDLE - cn.ass_upwindow_size)

        with np.errstate(divide="ignore"):
            self.log_len_intron = np.log(inp.len_dist)
            self.log_len_exon = {
                kind: np.log(arr) for kind, arr in exp.len_dist.items()}

    # ------------------------------------------------------------------
    def prepare(self, codes: np.ndarray, softmask=None,
                gff_hints=None) -> None:
        """Precompute all tracks for one sequence on the host (numpy).

        softmask: optional boolean per-base array (lowercase in the input).
        With softmasking on, masked runs become nonexonpart "RM" hints
        favoring intergenic/intron states (reference
        SequenceFeatureCollection::prepare, extrinsicinfo.cc:1697-1723).
        """
        self.collect_hints(codes, softmask, gff_hints)
        self.prepare_collected()

    def collect_hints(self, codes: np.ndarray, softmask=None,
                      gff_hints=None) -> None:
        """The chunk's codes and SeqHints (.codes, .n, .has_hints, .hints):
        the first half of `prepare`, which the device route also needs for
        the overlays and the evidence output."""
        cn, n = self.cn, codes.shape[0]
        self.codes = codes
        self.n = n
        self._kmer_full: Dict[tuple, np.ndarray] = {}
        self.has_hints = False
        self.hints = None
        feats = []
        if (softmask is not None and cn.softmasking
                and self.ext_cfg is not None):
            from ..hints.features import softmask_hints
            for grp in softmask_hints(softmask[:n], self.ext_cfg):
                feats.extend(grp.hints)
            # reference sets hasHintsFile whenever softmasking is on, even
            # with zero lowercase runs (extrinsicinfo.cc:1723) -> maluses
            # apply and evidence blocks are printed
            self.has_hints = True
        if gff_hints is not None:
            # a hints file was given: maluses apply even with no hints on
            # this sequence (reference hasHintsFile)
            feats.extend(gff_hints)
            self.has_hints = True
        if self.has_hints and self.ext_cfg is not None:
            from ..hints.system import SeqHints
            self.hints = SeqHints(feats, self.ext_cfg, codes)

    def prepare_collected(self) -> None:
        """The second half of `prepare`: the host route's tracks."""
        if self.hints is not None:
            self._build_hint_tracks()
        self.stairs = gcmod.compute_stairs(self.codes, self.cn, self.decomp)
        self._prepare_tracks(self.codes)

    # ------------------------------------------------------------------
    def _extra_cum_rows(self, zero) -> dict:
        """{attribute: (n+1,) row} of cumulative tracks that _prepare_tracks
        sums together with the content rows and sets as attributes; the
        host route sums its hint tracks where it builds them."""
        return {}

    def _prepare_tracks(self, codes: np.ndarray) -> None:
        """Sequence-content track building (ORF barriers, splice scores,
        content cumsums, signal sensors) in float64, on numpy or on the
        tensors of xputil.use_torch."""
        from . import xputil as U
        xp = U.A.xp
        cn, n = self.cn, self.n
        self.orf = T.nearest_stop_arrays(codes, self.gcode)
        hinted = getattr(self, "_hinted_override", None)
        if hinted is None and self.hints is not None:
            h = self.hints
            hinted = (h.hinted_fD, h.hinted_rD, h.hinted_fA, h.hinted_rA)
        self.splice = T.build_splice_tracks(codes, self.inp, cn,
                                            hinted=hinted)

        k = self.exp.k
        log_n_coding = float(np.log(cn.prob_n_in_coding))
        classes = list(range(len(self.inp.gc)))
        self.classes = classes

        # every row to be summed, gathered for one ordered prefix sum
        z = xp.zeros(1, dtype=U.ftype())
        rows = self._extra_cum_rows(z)

        # content tracks per class
        self.ig_track: Dict[int, np.ndarray] = {}
        self.intron_f: Dict[int, np.ndarray] = {}
        self.intron_r: Dict[int, np.ndarray] = {}
        self.cum_intron_f: Dict[int, np.ndarray] = {}
        self.cum_intron_r: Dict[int, np.ndarray] = {}
        self.cum_exon: Dict[Tuple[int, str, bool], np.ndarray] = {}
        for c in classes:
            self.ig_track[c] = self._igenic_track(codes, c)
            if self.hints is not None:
                self.ig_track[c] = self.ig_track[c] + self.ig_adjust
            # kmer_lookup_log already yields LOG_QUARTER below k = k1-1
            itf = T.kmer_lookup_log(codes, self.inp.k + 1,
                                    self.inp.gc[c].emiprobs, T.LOG_QUARTER)
            itr = T.rc_kmer_lookup_log(codes, self.inp.k + 1,
                                       self.inp.gc[c].emiprobs, T.LOG_QUARTER)
            self.intron_f_nb = getattr(self, "intron_f_nb", {})
            self.intron_f_nb[c] = itf
            self.intron_f[c] = itf
            self.intron_r[c] = itr
            rows[("intron", c, True)] = xp.concatenate([z, itf])
            rows[("intron", c, False)] = xp.concatenate([z, itr])

            gcp = self.exp.gc[c]
            for name, table in (("emi", gcp.emiprobs),
                                ("init", gcp.initemiprobs),
                                ("et", gcp.etemiprobs)):
                per_frame_f = U.stk([
                    T.kmer_lookup_log(codes, k + 1, table[f], log_n_coding)
                    for f in range(3)])
                per_frame_r = U.stk([
                    T.rc_kmer_lookup_log(codes, k + 1, table[f], log_n_coding)
                    for f in range(3)])
                rows[(c, name, True)] = T.phase_rows(per_frame_f,
                                                     reverse=False)
                rows[(c, name, False)] = T.phase_rows(per_frame_r,
                                                      reverse=True)
        for key, cum in U.cumsum_rows(rows).items():
            if isinstance(key, str):
                setattr(self, key, cum)
            elif key[0] == "intron":
                (self.cum_intron_f if key[2] else self.cum_intron_r)[
                    key[1]] = cum
            else:
                self.cum_exon[key] = cum

        # signal tracks
        self._build_signal_tracks(codes)

    def _build_hint_tracks(self) -> None:
        """Per-base hint bonus tracks (igenic adjust, intronpart cums) and
        constants used by the DP hooks."""
        h = self.hints
        cfg = self.ext_cfg
        n = self.n
        LOG = np.log

        ig = np.zeros(n)
        have_ir = np.zeros(n, dtype=bool)
        have_nep = np.zeros(n, dtype=bool)
        have_nonir = np.zeros(n, dtype=bool)
        for f in h.by_type["irpart"]:
            ig[max(f.start, 0): f.end + 1] += LOG(f.bonus)
            have_ir[max(f.start, 0): f.end + 1] = True
        for f in h.by_type["nonexonpart"]:
            ig[max(f.start, 0): f.end + 1] += LOG(f.bonus)
            have_nep[max(f.start, 0): f.end + 1] = True
        for f in h.by_type["genicpart"]:
            ig[max(f.start, 0): f.end + 1] -= LOG(f.bonus)
            have_nonir[max(f.start, 0): f.end + 1] = True
        # maluses where no such hint covers the base (igenicmodel.cc:318-326)
        ig += np.where(~have_ir, LOG(cfg.malus("irpart")), 0.0)
        ig += np.where(~have_nep, LOG(cfg.malus("nonexonpart")), 0.0)
        ig -= np.where(~have_nonir, LOG(cfg.malus("genicpart")), 0.0)
        self.ig_adjust = ig

        ipb_p = np.zeros(n)
        ipb_m = np.zeros(n)
        for f in h.by_type["intronpart"] + h.by_type["nonexonpart"]:
            if f.strand in ("+", "."):
                ipb_p[max(f.start, 0): f.end + 1] += LOG(f.bonus)
            if f.strand in ("-", "."):
                ipb_m[max(f.start, 0): f.end + 1] += LOG(f.bonus)
        self.ipb_plus = ipb_p
        self.ipb_minus = ipb_m
        self.ipb_plus_cum = np.zeros(n + 1)
        self.ipb_plus_cum[1:] = np.cumsum(ipb_p)
        self.ipb_minus_cum = np.zeros(n + 1)
        self.ipb_minus_cum[1:] = np.cumsum(ipb_m)

        self.log_malus = {t: float(LOG(cfg.malus(t)))
                          for t in ("start", "stop", "ass", "dss", "exonpart",
                                    "exon", "intronpart", "intron", "CDS",
                                    "CDSpart", "UTR", "UTRpart", "tss",
                                    "tts")}

        # local (part) malus coverage tables (reference
        # SequenceFeatureCollection::prepareLocalMalus,
        # extrinsicinfo.cc:1749-1818): cumulative count of bases NOT
        # covered by any CDSpart-or-exonpart hint, per strand.
        self.log_local_malus_cp = float(LOG(cfg.info("CDSpart").local_malus))
        for strand, attr in (("+", "cumcov_cp_plus"),
                             ("-", "cumcov_cp_minus")):
            cov = np.zeros(n, dtype=bool)
            for f in h.by_type["CDSpart"] + h.by_type["exonpart"]:
                if f.strand in (strand, "."):
                    cov[max(f.start, 0): f.end + 1] = True
            setattr(self, attr, np.cumsum(~cov).astype(np.int64))

    # ------------------------------------------------------------------
    def _igenic_track(self, codes: np.ndarray, c: int) -> np.ndarray:
        """Per-base igenic log emission (reference igenicmodel.cc:299):
        j > k: order-k chain (tied to the intron content model when
        configured); j <= k: conditional from the short-pattern P_l tables,
        replicating the reference's sibling-index arithmetic verbatim."""
        cn = self.cn
        igp = self.igp
        k = igp.k
        from . import xputil as U
        xp = U.A.xp
        tied = (cn.tie_igenic_intron and self.inp.gc
                and self.inp.gc[c].emiprobs.size > 0 and self.inp.k == k)
        table = self.inp.gc[c].emiprobs if tied else igp.gc[c].emiprobs
        out = T.kmer_lookup_log(codes, k + 1, table, T.LOG_QUARTER)
        # j <= k prefix: conditional short-pattern probabilities, replicating
        # the reference sibling-index arithmetic (static loop; numpy on the
        # first k+1 bases on either backend)
        n_ = codes.shape[0]
        pls = igp.gc[c].pls
        head_codes = U.host(codes[: k + 1])
        head = []
        for j in range(min(k + 1, n_)):
            window = head_codes[: j + 1].astype(np.int64)
            bad = (window == genetics.N).any()
            idx = np.zeros((), dtype=np.int64)
            for bi in range(j + 1):
                idx = (idx << 2) | np.where(window[bi] == genetics.N, 0,
                                            window[bi])
            vals = np.asarray(pls[j])
            sz = pls[j].size
            denom_base = idx // 4
            denom = (vals[denom_base]
                     + vals[np.minimum(denom_base + 1, sz - 1)]
                     + vals[np.minimum(denom_base + 2, sz - 1)]
                     + vals[np.minimum(denom_base + 3, sz - 1)])
            vi = vals[idx]
            good = (~bad) & (denom > 0) & (vi > 0)
            val = np.where(good,
                           T._safe_log(np.where(good, vi, 1.0) /
                                       np.where(denom > 0, denom, 1.0)),
                           T.LOG_QUARTER)
            head.append(np.reshape(val, (1,)))
        if head:
            out = xp.concatenate([U.asarr(np.concatenate(head)),
                                  out[len(head):]])
        return out

    # ------------------------------------------------------------------
    def _build_signal_tracks(self, codes: np.ndarray) -> None:
        from . import xputil as U
        xp = U.A.xp
        cn, n = self.cn, self.n
        gcode = self.gcode
        cds = codes

        # stop-codon endPart for terminal/singleG ending at DP base j:
        # stop codon at stppos = j-2 (reference exonmodel.cc:1276-1311)
        c64 = U.astype(cds, np.int64)
        # translation-table gating (reference exonmodel.cc:216 'give the
        # chosen translation table priority over {ochre,amber,opal}prob'):
        # a codon only scores as a stop if the table says it is one
        is_stop = self.gcode.is_stop
        ochre_on = bool(is_stop[genetics.codon_index("taa")])
        amber_on = bool(is_stop[genetics.codon_index("tag")])
        opal_on = bool(is_stop[genetics.codon_index("tga")])
        if n >= 3:
            i0, i1, i2 = c64[:-2], c64[1:-1], c64[2:]
            A, C, G, Tt = (genetics.A, genetics.C, genetics.G, genetics.T)
            taa = (i0 == Tt) & (i1 == A) & (i2 == A) & ochre_on
            tag = (i0 == Tt) & (i1 == A) & (i2 == G) & amber_on
            tga = (i0 == Tt) & (i1 == G) & (i2 == A) & opal_on
            per_pos = xp.where(
                taa, np.log(cn.ochreprob),
                xp.where(tag, np.log(cn.amberprob),
                         xp.where(tga, np.log(cn.opalprob), NEG_INF)))
            # stppos must satisfy 0 <= stppos <= n-3
            self.stop_at_log = per_pos           # index = stppos
            stop_log = xp.concatenate(
                [xp.full(2, NEG_INF, dtype=U.ftype()), per_pos[: n - 2]])
        else:
            self.stop_at_log = xp.full(max(n - 2, 0), NEG_INF, dtype=U.ftype())
            stop_log = xp.full(n, NEG_INF, dtype=U.ftype())
        self.end_stop_fwd = stop_log

        # reverse stop codon beginPart (rsingleG/rterminal) at beginOfBioExon
        if n >= 3:
            tta = (i0 == Tt) & (i1 == Tt) & (i2 == A) & ochre_on
            cta = (i0 == C) & (i1 == Tt) & (i2 == A) & amber_on
            tca = (i0 == Tt) & (i1 == C) & (i2 == A) & opal_on
            rhead = xp.where(
                tta, np.log(cn.ochreprob),
                xp.where(cta, np.log(cn.amberprob),
                         xp.where(tca, np.log(cn.opalprob), NEG_INF)))
            rstop = xp.concatenate(
                [rhead, xp.full(2, NEG_INF, dtype=U.ftype())])
        else:
            rstop = xp.full(n, NEG_INF, dtype=U.ftype())
        self.begin_rstop = rstop

        # start codons
        start_prob = np.zeros(64)
        probs_src = self.exp.start_codon_probs
        if probs_src:
            for pn, p in probs_src.items():
                start_prob[pn] = p
        else:
            start_prob[14] = 1.0   # atg
        if n >= 3:
            cod = (c64[:-2] * 16 + c64[1:-1] * 4 + c64[2:])
            valid = (c64[:-2] != genetics.N) & (c64[1:-1] != genetics.N) & \
                (c64[2:] != genetics.N)
            sf = xp.where(valid,
                          T.log_take(start_prob, xp.where(valid, cod, 0)),
                          NEG_INF)
            tail2 = xp.full(2, NEG_INF, dtype=U.ftype())
            start_fwd = xp.concatenate([sf, tail2])
            # reverse: codon read as rc of [pos, pos+2]
            comp = U.astype(U.asarr(genetics.COMPLEMENT)[cds], np.int64)
            rcod = comp[2:] * 16 + comp[1:-1] * 4 + comp[:-2]
            sr = xp.where(valid, T.log_take(start_prob,
                                            xp.where(valid, rcod, 0)),
                          NEG_INF)
            start_rev = xp.concatenate([sr, tail2])
        else:
            start_fwd = xp.full(n, NEG_INF, dtype=U.ftype())   # atg at pos
            start_rev = xp.full(n, NEG_INF, dtype=U.ftype())   # 'cat' at pos

        # TIS begin (initial/singleG): beginOfBioExon = bob needs start codon
        # at bob plus the upstream translation-initiation motif
        # (reference exonmodel.cc:1426-1461)
        self.tis_begin_fwd: Dict[int, np.ndarray] = {}
        self.tis_end_rev: Dict[int, np.ndarray] = {}
        tw = cn.trans_init_window
        for c in self.classes:
            motif = self.exp.gc[c].trans_init_motif
            mf = T.motif_score_fwd(cds, motif)
            mr = T.motif_score_rc(cds, motif)
            bob = U.arange(n)
            tis_start = bob - tw
            use_motif = tis_start > motif.k
            motif_term = xp.where(
                use_motif, U.sg(mf, -tw, n),
                bob * T.LOG_QUARTER)    # pow(.25, beginOfStart-3), bOS-3=bob
            val = start_fwd + motif_term
            val = xp.where(bob >= n - 2, NEG_INF, val)
            tb = self.exp.gc[c].tis_bin
            if tb.nbins > 0:
                ok = val > NEG_INF
                val = xp.where(
                    ok, _log_bin(tb, xp.exp(xp.where(ok, val, 0.0))), val)
            self.tis_begin_fwd[c] = val

            # reverse TIS endPart at DP base j: startpos = j - tw - 3 + 1
            j = U.arange(n)
            sp = j - tw - STARTCODON_LEN + 1
            ok = sp >= 0
            val = xp.where(ok, U.sg(start_rev, -tw - STARTCODON_LEN + 1, n),
                           NEG_INF)
            # motif right after the start codon, in rc orientation
            mstart = sp + STARTCODON_LEN
            in_range = mstart + tw - 1 + motif.k < n
            motif_term = xp.where(
                in_range, U.sg(mr, 1 - tw, n),
                (n - mstart) * T.LOG_QUARTER)
            val = val + motif_term
            if tb.nbins > 0:
                okv = val > NEG_INF
                val = xp.where(okv, _log_bin(tb, xp.exp(xp.where(okv, val,
                                                                 0.0))), val)
            self.tis_end_rev[c] = val

        self.start_fwd_log = start_fwd

        if self.hints is not None:
            self._apply_signal_hint_terms()

    # ------------------------------------------------------------------
    def _apply_signal_hint_terms(self) -> None:
        """Fold start/stop/ass/dss hint bonuses and maluses into signal
        tracks (reference exonmodel.cc endPartEmiProb/notEndPartEmiProb)."""
        from ..hints.system import distance_faded_bonus
        h, n = self.hints, self.n
        lm = self.log_malus

        def codon_adj(hint_type, strand, pos_of_j, valid):
            """Adjustment for codon-signal tracks: hints OVERLAPPING the
            codon window suppress the malus; hints COVERING it add fades at
            the middle base (reference exonmodel.cc:1294-1311)."""
            adj = np.where(valid, lm[hint_type], 0.0)
            hints = [f for f in h.by_type[hint_type]
                     if f.strand in (strand, ".")]
            if not hints:
                return adj
            for j in np.flatnonzero(valid):
                a = pos_of_j(int(j))          # codon start
                over = [f for f in hints if not (f.end < a or f.start > a + 2)]
                if over:
                    v = 0.0
                    for f in over:
                        if f.start <= a and f.end >= a + 2:
                            v += distance_faded_bonus(f, a + 1)
                    adj[j] = v
            return adj

        tw = self.cn.trans_init_window
        self.end_stop_fwd = self.end_stop_fwd + codon_adj(
            "stop", "+", lambda j: j - 2, self.end_stop_fwd > NEG_INF)
        self.begin_rstop = self.begin_rstop + codon_adj(
            "stop", "-", lambda b: b, self.begin_rstop > NEG_INF)
        for c in self.classes:
            self.tis_begin_fwd[c] = self.tis_begin_fwd[c] + codon_adj(
                "start", "+", lambda b: b, self.tis_begin_fwd[c] > NEG_INF)
            self.tis_end_rev[c] = self.tis_end_rev[c] + codon_adj(
                "start", "-", lambda j: j - tw - STARTCODON_LEN + 1,
                self.tis_end_rev[c] > NEG_INF)

        # splice-site adjustment arrays indexed by SITE position:
        # sum of fades of containing hints, else the malus
        def site_adj(hint_type, strand):
            adj = np.full(n, lm[hint_type])
            hints = [f for f in h.by_type[hint_type]
                     if f.strand in (strand, ".")]
            for f in hints:
                for p in range(max(f.start, 0), min(f.end + 1, n)):
                    if adj[p] == lm[hint_type]:
                        adj[p] = 0.0
                    adj[p] += distance_faded_bonus(f, p)
            return adj

        self.dss_site_adj_p = site_adj("dss", "+")
        self.dss_site_adj_m = site_adj("dss", "-")
        self.ass_site_adj_p = site_adj("ass", "+")
        self.ass_site_adj_m = site_adj("ass", "-")

    # ------------------------------------------------------------------
    def log_pls(self, c: int, m: int) -> np.ndarray:
        """log of exp.gc[c].pls[m], 0 -> NEG_INF (cached on the shared
        ExonParams so all pieces of a run reuse it; bitwise equal to
        np.log(np.maximum(v, 1e-300)) on the positive entries)."""
        cache = getattr(self.exp, "_log_pls_cache", None)
        if cache is None:
            cache = {}
            try:
                self.exp._log_pls_cache = cache
            except Exception:
                pass
        key = (c, m)
        if key not in cache:
            v = self.exp.gc[c].pls[m]
            out = np.full(v.shape, NEG_INF)
            nz = v > 0
            out[nz] = np.log(np.maximum(v[nz], 1e-300))
            cache[key] = out
        return cache[key]

    def kmer_ids_full(self, k: int) -> np.ndarray:
        """Cached kmer_ids over the whole sequence (O(n) once per k; the
        per-candidate callers read single elements)."""
        key = ("f", k)
        if key not in self._kmer_full:
            self._kmer_full[key] = genetics.kmer_ids(self.codes, k)
        return self._kmer_full[key]

    def rc_kmer_ids_full(self, k: int) -> np.ndarray:
        key = ("r", k)
        if key not in self._kmer_full:
            self._kmer_full[key] = genetics.rc_kmer_ids(self.codes, k)
        return self._kmer_full[key]

    def set_boundaries(self, init_synch: bool, term_synch: bool) -> None:
        """Piecewise decoding boundary handling (reference namgene.cc:594):
        at an interior cut point the piece must start/end in the synch
        (igenic) state with probability 1."""
        synch = np.full(self.S, NEG_INF)
        synch[self.sg.type_to_index[ST.igenic]] = 0.0
        self.boundary_flags = (bool(init_synch), bool(term_synch))
        with np.errstate(divide="ignore"):
            self.log_init = synch if init_synch else np.log(self.sg.init_probs)
            self.log_term = synch if term_synch else np.log(self.sg.term_probs)

    # ------------------------------------------------------------------
    # main DP

    # ------------------------------------------------------------------
    # sampling walk over a forward table (host numpy)
    # ------------------------------------------------------------------
    def _classify_states(self) -> None:
        types = self.sg.state_types
        self._kind = []
        for s in range(self.S):
            t = types[s]
            mc = self.sg.model_class[s]
            if t == ST.igenic or t in (
                    ST.geometric0, ST.geometric1, ST.geometric2,
                    ST.rgeometric0, ST.rgeometric1, ST.rgeometric2):
                self._kind.append("chain")
            elif t in (ST.lessD0, ST.lessD1, ST.lessD2,
                       ST.rlessD0, ST.rlessD1, ST.rlessD2):
                self._kind.append("lessd")
            elif mc == "intronmodel":
                self._kind.append("fixed")
            elif mc == "exonmodel":
                self._kind.append("exon")
            else:
                self._kind.append("other")

    def _state_cands(self, j, c, s, table):
        """Candidate (weights, pred states, pred end positions) for state s
        at position j, in reference iteration order (argmax-first ==
        reference strictly-greater update order)."""
        kind = self._kind[s]
        t = self.sg.state_types[s]
        if kind == "chain":
            return self._chain_cands(j, c, s, table)
        if kind == "fixed":
            return self._fixed_intron_cands(j, c, s, t, table)
        if kind == "lessd":
            return self._lessd_cands(j, c, s, t, table)
        if kind == "exon":
            return self._exon_cands(j, c, s, t, table)
        return None

    # ------------------------------------------------------------------
    def sample_path(self, rng) -> List[Tuple[int, int, ST]]:
        """Ancestral sampling from the forward table (reference
        NAMGene::getSampledPath, src/namgene.cc:367).

        ``rng`` is a crand.GlibcRand replicating the reference's unseeded C
        rand() stream; options are stable-sorted by descending probability
        before drawing (OptionsList::prepareSampling/sample,
        include/vitmatrix.hh:794, src/vitmatrix.cc:295), so posterior
        probabilities reproduce the reference byte-exactly.
        """
        assert self.f is not None, "fill .f with a forward table first"
        n, S = self.n, self.S
        last = self.f[n - 1] + self.log_term
        state = self._sample_options(rng, last)
        segs: List[Tuple[int, int, ST]] = []
        base = n - 1
        types = self.sg.state_types
        while base > 0:
            c = int(self.stairs[base])
            res = self._heat_cands(
                self.f, self._state_cands(base, c, state, self.f))
            if res is None:
                raise RuntimeError(
                    f"sampling stuck at base {base} state {state}")
            w, preds, eops = res
            k = self._sample_options(rng, w)
            segs.append((int(eops[k]) + 1, base, types[state]))
            base, state = int(eops[k]), int(preds[k])
        segs.reverse()
        return segs

    def _heat_cands(self, table, res):
        """Sampling-temperature heating (reference include/types.hh:387,
        lldouble.hh heated(): transEmiProb^((8-temperature)/8) in the
        FORWARD recursion and the sampling walk only; Viterbi is
        unheated).  Candidate totals are pv + transEmi-log with
        pv = table[max(eop, 0), pred] (every candidate builder's
        convention), so the heat factor applies to (w - pv)."""
        t = getattr(self.cn, "temperature", 0)
        if res is None or not t:
            return res
        h = (8.0 - t) / 8.0
        w, preds, eops = res
        pv = table[np.maximum(np.asarray(eops), 0), preds]
        wh = np.where(w > NEG_INF, pv + h * (w - pv), NEG_INF)
        return wh, preds, eops

    @staticmethod
    def _sample_options(rng, logw: np.ndarray) -> int:
        """Draw one option index (into logw, insertion order) the way
        OptionsList::sample does: z = u * cumprob * 0.99999 with cumprob
        summed in insertion order, then first sorted-descending option whose
        running sum exceeds z; fallback to the largest option."""
        sel = np.flatnonzero(logw > NEG_INF)
        if sel.shape[0] == 0:
            raise RuntimeError("sampling from empty option list")
        w = logw[sel]
        m = float(np.max(w))
        q = np.exp(w - m)
        cumprob = float(np.cumsum(q)[-1])        # insertion-order sum
        z = rng.uniform() * cumprob * 0.99999
        order = np.argsort(-q, kind="stable")    # stable: ties keep order
        csum = np.cumsum(q[order])
        hit = np.flatnonzero(z < csum)
        pick = int(order[hit[0]]) if hit.shape[0] else int(order[0])
        return int(sel[pick])

    def _chain_cands(self, j, c, s, table):
        """Candidates for per-base chain states; returns (w, preds, eops)."""
        types = self.sg.state_types
        anc = self.ancestors[s]
        emi = (self.ig_track[c][j] if types[s] == ST.igenic
               else self.intron_f[c][j])
        if self.hints is not None and types[s] != ST.igenic:
            if types[s] in (ST.geometric0, ST.geometric1, ST.geometric2):
                emi = emi + self.ipb_plus[j]
            else:
                emi = emi + self.ipb_minus[j]
        w = table[j - 1][anc] + self.log_trans[c][anc, s] + emi
        return w, anc, np.full(anc.shape[0], j - 1)

    def _fixed_intron_cands(self, j, c, s, t, table):
        cn = self.cn
        sp = self.splice
        dsl = self.d_state_len
        n = self.n
        if t in (ST.longdss0, ST.longdss1, ST.longdss2):
            eop = j - cn.dss_whole_size
            if eop < 0 or not T.is_possible_dss(
                    sp.dss_ok, j - cn.dss_end - DSS_MIDDLE + 1):
                return None
            emi = sp.dss_score[j - cn.dss_whole_size + 1]
        elif t in (ST.rlongdss0, ST.rlongdss1, ST.rlongdss2):
            eop = j - cn.dss_whole_size
            if eop < 0 or not T.is_possible_rdss(sp.rdss_ok,
                                                 j - cn.dss_start):
                return None
            emi = sp.rdss_score[j - cn.dss_whole_size + 1]
        elif t in (ST.equalD0, ST.equalD1, ST.equalD2):
            eop = j - dsl
            if eop < 0:
                return None
            emi = self.cum_intron_f[c][j + 1] - self.cum_intron_f[c][eop + 1]
        elif t in (ST.requalD0, ST.requalD1, ST.requalD2):
            # quirk: requalD uses forward-strand patterns
            # (reference IntronModel::seqProb generic branch)
            eop = j - dsl
            if eop < 0:
                return None
            emi = self.cum_intron_f[c][j + 1] - self.cum_intron_f[c][eop + 1]
        elif t in (ST.longass0, ST.longass1, ST.longass2):
            eop = j - cn.ass_whole_size - cn.ass_upwindow_size
            if eop < 0 or not T.is_possible_ass(sp.ass_ok, j - cn.ass_end):
                return None
            emi = sp.ass_score[c][eop + 1]
        elif t in (ST.rlongass0, ST.rlongass1, ST.rlongass2):
            eop = j - cn.ass_whole_size - cn.ass_upwindow_size
            if eop < 0 or not T.is_possible_rass(
                    sp.rass_ok,
                    j - cn.ass_upwindow_size - cn.ass_start - ASS_MIDDLE + 1):
                return None
            emi = sp.rass_score[c][eop + 1]
        else:
            return None
        if emi == NEG_INF:
            return None
        if self.hints is not None:
            # intronic sub-range of the splice windows
            # (reference intron emiProbUnderModel: intronBegin/intronEnd)
            fwd_t = t in (ST.longdss0, ST.longdss1, ST.longdss2,
                          ST.longass0, ST.longass1, ST.longass2,
                          ST.equalD0, ST.equalD1, ST.equalD2)
            smc = self.ipb_plus_cum if fwd_t else self.ipb_minus_cum
            if t in (ST.longdss0, ST.longdss1, ST.longdss2):
                emi = emi + smc[j + 1] - smc[j - DSS_MIDDLE - cn.dss_end + 1]
            elif t in (ST.rlongdss0, ST.rlongdss1, ST.rlongdss2):
                emi = emi + smc[j - cn.dss_start + 1] - smc[eop + 1]
            elif t in (ST.longass0, ST.longass1, ST.longass2):
                emi = emi + smc[j - cn.ass_end + 1] - smc[eop + 1]
            elif t in (ST.rlongass0, ST.rlongass1, ST.rlongass2):
                emi = emi + smc[j + 1] - smc[eop + 1 + cn.ass_end]
            elif t in (ST.equalD0, ST.equalD1, ST.equalD2,
                       ST.requalD0, ST.requalD1, ST.requalD2):
                emi = emi + smc[j + 1] - smc[eop + 1] \
                    + self.log_malus["intron"]
        anc = self.ancestors[s]
        w = table[eop][anc] + self.log_trans[c][anc, s] + emi
        return w, anc, np.full(anc.shape[0], eop)

    def _lessd_cands(self, j, c, s, t, table):
        cn, n = self.cn, self.n
        sp = self.splice
        dsl = self.d_state_len
        fwd = t in (ST.lessD0, ST.lessD1, ST.lessD2)
        if fwd:
            ebi = j + cn.ass_upwindow_size + cn.ass_start + ASS_MIDDLE
            if ebi - ASS_MIDDLE + 1 < n - 1 and not T.is_possible_ass(
                    sp.ass_ok, ebi):
                return None
        else:
            ebi = j + cn.dss_end + DSS_MIDDLE
            if ebi - DSS_MIDDLE + 1 < n - 1 and not T.is_possible_rdss(
                    sp.rdss_ok, ebi):
                return None
        lo = max(j - dsl, 0)
        eops = np.arange(j - 1, lo - 1, -1)       # descending like reference
        if eops.size == 0:
            return None
        begins = eops + 1
        if fwd:
            bbi = begins - cn.dss_end - DSS_MIDDLE
            ok = ~((bbi >= 0) & ~T.is_possible_dss(sp.dss_ok, bbi))
            seg = self.cum_intron_f[c][j + 1] - self.cum_intron_f[c][begins]
        else:
            bbi = begins - cn.ass_outside
            ok = ~((bbi >= 0) & ~T.is_possible_rass(sp.rass_ok, bbi))
            seg = self.cum_intron_r[c][j + 1] - self.cum_intron_r[c][begins]
        # spliced in-frame stop codon exclusion (reference
        # intronmodel.cc:560-580 + emiProbUnderModel lessD branch)
        ok &= ~self._spliced_stop(t, bbi, ebi)
        if self.hints is not None:
            ipbc = self.ipb_plus_cum if fwd else self.ipb_minus_cum
            seg = seg + (ipbc[j + 1] - ipbc[begins]) \
                + self.log_malus["intron"]
        length = ebi - bbi + 1
        ld = np.where((length >= 0) & (length <= self.inp.d),
                      self.log_len_intron[np.clip(length, 0,
                                                  self.inp.d)], NEG_INF)
        emi = np.where(ok, seg + ld, NEG_INF)
        anc = self.ancestors[s]
        w = table[eops][:, anc] + self.log_trans[c][anc, s][None, :] \
            + emi[:, None]
        na = anc.shape[0]
        return (w.reshape(-1), np.tile(anc, eops.shape[0]),
                np.repeat(eops, na))

    def _spliced_stop(self, t: ST, bbi: np.ndarray, ebi: int) -> np.ndarray:
        """True where splicing the intron [bbi..ebi] with state type t joins a
        stop codon across the splice boundary."""
        n, codes = self.n, self.codes
        out = np.zeros(bbi.shape[0], dtype=bool)
        if t in (ST.lessD0, ST.rlessD2):
            return out

        def ch(i):
            return codes[i] if 0 <= i < n else genetics.N

        def comp(x):
            return genetics.COMPLEMENT[x]

        # right-side bases (fixed given ebi); 'n' if they extend past the end
        if ebi < n - 2:
            r1, r2 = codes[ebi + 1], codes[ebi + 2]
        else:
            r1 = r2 = genetics.N
        is_stop = self.gcode.is_stop
        guard = bbi > 1
        # codon composition per type (reference fills codon[] from both sides)
        if t == ST.lessD1:
            l0 = np.array([ch(int(b) - 1) for b in bbi])
            cod = (l0.astype(np.int64), np.full_like(bbi, r1),
                   np.full_like(bbi, r2))
        elif t == ST.lessD2:
            l0 = np.array([ch(int(b) - 2) for b in bbi])
            l1 = np.array([ch(int(b) - 1) for b in bbi])
            cod = (l0.astype(np.int64), l1.astype(np.int64),
                   np.full_like(bbi, r1))
        elif t == ST.rlessD0:
            l1 = np.array([comp(ch(int(b) - 1)) for b in bbi])
            l2 = np.array([comp(ch(int(b) - 2)) for b in bbi])
            cod = (np.full_like(bbi, comp(r1)), l1.astype(np.int64),
                   l2.astype(np.int64))
        elif t == ST.rlessD1:
            l2 = np.array([comp(ch(int(b) - 1)) for b in bbi])
            cod = (np.full_like(bbi, comp(r2)), np.full_like(bbi, comp(r1)),
                   l2.astype(np.int64))
        else:
            return out
        c0, c1, c2 = cod
        valid = (c0 != genetics.N) & (c1 != genetics.N) & (c2 != genetics.N)
        idx = np.where(valid, c0 * 16 + c1 * 4 + c2, 0)
        out = guard & valid & is_stop[idx]
        return out

    # ------------------------------------------------------------------
    def _exon_cands(self, j, c, s, t, table):
        cn, n = self.cn, self.n
        g = self.geom[t]
        sp = self.splice

        # ---- endPart ----------------------------------------------------
        if t in (ST.singleG, ST.terminal):
            end_part = self.end_stop_fwd[j]
        elif t in (ST.rsingleG, ST.rinitial):
            end_part = self.tis_end_rev[c][j]
        elif t in (ST.initial0, ST.initial1, ST.initial2,
                   ST.internal0, ST.internal1, ST.internal2):
            dsspos = j + cn.dss_start + 1
            if j == n - 1:
                end_part = 0.0
            elif ((dsspos + DSS_MIDDLE - 1 < n
                   and not T.is_possible_dss(sp.dss_ok, dsspos))
                  or j + cn.dss_start >= n):
                end_part = NEG_INF
            else:
                # NB: the reference passes the RAW value win-1 (which is -1
                # for win==0) to leftmostExonBegin — replicate, don't mod3.
                lmb = int(T.leftmost_exon_begin(self.orf, g.win - 1,
                                                j + cn.dss_start, True, cn, n))
                end_part = NEG_INF if lmb >= j else 0.0
            if end_part > NEG_INF and self.hints is not None:
                p = j + cn.dss_start + 1
                end_part = end_part + (self.dss_site_adj_p[p] if 0 <= p < n
                                       else self.log_malus["dss"])
        else:  # rterminal*, rinternal*
            asspos = j + cn.ass_end + 1
            if j == n - 1:
                end_part = 0.0
            elif (j + cn.ass_end + ASS_MIDDLE < n
                  and T.is_possible_rass(sp.rass_ok, asspos)):
                end_part = 0.0
            else:
                end_part = NEG_INF
            if end_part > NEG_INF and self.hints is not None:
                p = j + cn.ass_end + 1
                end_part = end_part + (self.ass_site_adj_m[p] if 0 <= p < n
                                       else self.log_malus["ass"])
        if end_part == NEG_INF:
            return None

        end_of_bio = j + g.base_offset
        right = end_of_bio - g.inner_part_end_offset
        if right < 0:
            return None
        if g.forward:
            frame_of_right = mod3(g.win - (end_of_bio + 1) + right)
        else:
            frame_of_right = mod3(g.win + end_of_bio + 1 - right)

        eon = end_of_bio - STOPCODON_LEN if t in (ST.terminal, ST.singleG) \
            else end_of_bio
        if eon > n - 1:
            eon = n - 1
        if g.forward:
            f_eon = mod3(g.win - 1 - end_of_bio + eon)
        else:
            f_eon = mod3(g.win + 1 + end_of_bio - eon)
        orf_left = int(T.leftmost_exon_begin(self.orf, f_eon, eon, g.forward,
                                             cn, n))

        start_max = end_of_bio + g.inner_part_offset - cn.min_exon_length + 1
        if t in (ST.rterminal0, ST.rterminal1, ST.rterminal2, ST.rsingleG):
            start_min = start_max = orf_left + 2
        else:
            start_min = 0 if orf_left <= 0 else orf_left + g.inner_part_offset
            if start_max > j + g.begin_part_len:
                start_max = j + g.begin_part_len
        if start_max < start_min:
            return None

        bs = np.arange(start_max, start_min - 1, -1)     # descending
        eops = bs - g.begin_part_len - 1
        keep = eops < n
        bs, eops = bs[keep], eops[keep]
        if bs.size == 0:
            return None

        note = self._not_end_part(t, c, g, bs, right, int(frame_of_right))
        valid = note > NEG_INF
        if not valid.any():
            return None

        bob = bs - g.inner_part_offset
        exon_len = end_of_bio - bob + 1
        anc = self.ancestors[s]
        pred_cols = np.maximum(eops, 0)
        pv = table[pred_cols][:, anc]                    # (nb, na)
        lt = self.log_trans[c]
        total = pv + lt[anc, s][None, :] + (end_part + note)[:, None]

        # reading-frame compatibility with the predecessor state
        if t not in (ST.singleG, ST.rsingleG, ST.rterminal0, ST.rterminal1,
                     ST.rterminal2, ST.initial0, ST.initial1, ST.initial2):
            pred_frames = STATE_READING_FRAMES[
                [self.sg.state_types[a] for a in anc]]
            if g.forward:
                need = mod3(pred_frames[None, :] + exon_len[:, None])
            else:
                need = mod3(pred_frames[None, :] - exon_len[:, None])
            total = np.where(need == g.win, total, NEG_INF)

        total = np.where(valid[:, None], total, NEG_INF)
        na = anc.shape[0]
        return (total.reshape(-1), np.tile(anc, bs.shape[0]),
                np.repeat(eops, na))

    def _not_end_part(self, t: ST, c: int, g: ExonGeometry, bs: np.ndarray,
                      right: int, frame_of_right: int) -> np.ndarray:
        """Vectorized ExonModel::notEndPartEmiProb over begin positions."""
        cn, n = self.cn, self.n
        sp = self.splice
        codes = self.codes
        bob = bs - g.inner_part_offset
        k = self.exp.k
        log_nc = float(np.log(cn.prob_n_in_coding))

        # ---- beginPart --------------------------------------------------
        if t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2):
            begin = np.where((bob >= 0) & (bob < n),
                             self.tis_begin_fwd[c][np.clip(bob, 0, n - 1)],
                             NEG_INF)
        elif t in (ST.terminal, ST.internal0, ST.internal1, ST.internal2):
            shortcut = (bob < 0) | ((bob - ASS_MIDDLE >= 0) &
                                    ~T.is_possible_ass(sp.ass_ok, bob - 1))
            begin = np.where(bs > 0, np.where(shortcut, NEG_INF, 0.0),
                             np.where(bs == 0, 0.0, NEG_INF))
            if self.hints is not None:
                padj = np.where(
                    (bob - 1 >= 0) & (bob - 1 < n),
                    self.ass_site_adj_p[np.clip(bob - 1, 0, n - 1)],
                    self.log_malus["ass"])
                begin = np.where((bs > 0) & (begin > NEG_INF),
                                 begin + padj, begin)
        elif t in (ST.rsingleG, ST.rterminal0, ST.rterminal1, ST.rterminal2):
            begin = np.where((bob >= 0) & (bob < n),
                             self.begin_rstop[np.clip(bob, 0, n - 1)], NEG_INF)
        else:  # rinitial, rinternal*
            blocked = (bob < 0) | ((bob - DSS_MIDDLE > 0) &
                                   ~T.is_possible_rdss(sp.rdss_ok, bob - 1))
            begin = np.where(bs == 0, 0.0,
                             np.where(blocked, NEG_INF, 0.0))
            if self.hints is not None:
                # malus only when beginOfBioExon > 0 (exonmodel.cc:1534)
                padj = np.where(
                    (bob - 1 >= 0) & (bob - 1 < n),
                    self.dss_site_adj_m[np.clip(bob - 1, 0, n - 1)], 0.0)
                begin = np.where((bs != 0) & (begin > NEG_INF),
                                 begin + padj, begin)

        # ---- restSeqProb ------------------------------------------------
        rest = self._rest_seq(t, c, g, bs, right, frame_of_right)

        # ---- length -----------------------------------------------------
        end_of_bio = right + g.inner_part_end_offset
        exon_len = end_of_bio - bob + 1
        le = np.clip(exon_len, 0, cn.max_exon_len)
        L3 = float(np.log(3.0))
        lend = self.log_len_exon
        if t in (ST.singleG, ST.rsingleG):
            lp = np.where((exon_len >= 1) & (exon_len % 3 == 0),
                          L3 + lend["single"][le], NEG_INF)
        elif t in (ST.initial0, ST.initial1, ST.initial2):
            lp = np.where((exon_len > 2) & (exon_len % 3 == g.win),
                          L3 + lend["initial"][le], NEG_INF)
        elif t == ST.rinitial:
            lp = np.where(exon_len > 2, L3 + lend["initial"][le], NEG_INF)
        elif t in (ST.internal0, ST.internal1, ST.internal2,
                   ST.rinternal0, ST.rinternal1, ST.rinternal2):
            lp = np.where(exon_len >= 1, L3 + lend["internal"][le], NEG_INF)
        elif t == ST.terminal:
            lp = np.where(exon_len >= 1, L3 + lend["terminal"][le], NEG_INF)
        else:  # rterminal*
            lp = np.where((exon_len >= 1) & (mod3(2 - exon_len) == g.win),
                          L3 + lend["terminal"][le], NEG_INF)

        out = begin + rest + lp
        if self.hints is not None:
            out = out + self._exon_part_quot(t, g, bs, bob, exon_len,
                                             end_of_bio)
        return out

    # ------------------------------------------------------------------
    def _exon_part_quot(self, t: ST, g: ExonGeometry, bs: np.ndarray,
                        bob: np.ndarray, exon_len: np.ndarray,
                        end_of_bio: int) -> np.ndarray:
        """exonpart/CDSpart/exon/CDS hint bonuses and maluses per candidate
        (reference exonmodel.cc:1769-1860).  Vectorized over begins."""
        h = self.hints
        lm = self.log_malus
        nb = bs.shape[0]
        quot = np.zeros(nb)
        part_bonus = np.zeros(nb)
        nep = np.zeros(nb, dtype=np.int64)
        num_ep = np.zeros(nb, dtype=np.int64)
        num_cp = np.zeros(nb, dtype=np.int64)
        exon_support = np.zeros(nb, dtype=bool)
        cds_support = np.zeros(nb, dtype=bool)
        fwd = g.forward
        left_anchor = t in (ST.singleG, ST.initial0, ST.initial1, ST.initial2,
                            ST.rsingleG, ST.rterminal0, ST.rterminal1,
                            ST.rterminal2)
        right_anchor = t in (ST.singleG, ST.terminal, ST.rsingleG,
                             ST.rinitial)
        ebx = np.asarray(end_of_bio)     # scalar or per-candidate vector
        parts = h.ovlping(["exonpart", "CDSpart", "exon", "CDS"],
                          int(bob.min()), int(ebx.max()), "both")
        for f in parts:
            strand_ok = (f.strand == ".") or                 (fwd == (f.strand == "+"))
            LOGB = float(np.log(f.bonus))
            if f.type in ("exonpart", "CDSpart"):
                end_in = (f.end >= bob) & (f.end <= ebx)
                if f.type == "exonpart":
                    num_ep += end_in
                else:
                    num_cp += end_in
                if strand_ok:
                    inside = (f.start >= bob) & (f.end <= ebx)
                    part_bonus += np.where(inside, LOGB, 0.0)
                    nep += inside
                    if f.type == "exonpart":
                        if left_anchor:
                            half = (~inside) & end_in
                            part_bonus += np.where(half, 0.5 * LOGB, 0.0)
                            nep += half
                        if right_anchor:
                            start_in = (~inside) & (f.start >= bob) &                                 (f.start <= ebx)
                            part_bonus += np.where(start_in, 0.5 * LOGB, 0.0)
                            nep += start_in
            elif f.type == "CDS":
                match = strand_ok & (f.start == bob) & (f.end == ebx)
                quot += np.where(match, LOGB, 0.0)
                cds_support |= match
            elif f.type == "exon" and strand_ok:
                if t in (ST.singleG, ST.rsingleG):
                    pass
                elif t in (ST.internal0, ST.internal1, ST.internal2,
                           ST.rinternal0, ST.rinternal1, ST.rinternal2):
                    match = (f.start == bob) & (f.end == ebx)
                    quot += np.where(match, LOGB, 0.0)
                    exon_support |= match
                elif t in (ST.terminal, ST.rinitial):
                    match = (f.start == bob) & (f.end > ebx)
                    quot += np.where(match, 0.5 * LOGB, 0.0)
                    exon_support |= match
                else:
                    match = (f.start < bob) & (f.end == ebx)
                    quot += np.where(match, 0.5 * LOGB, 0.0)
                    exon_support |= match
        quot += part_bonus
        # local part malus for unevenly supported CDS (nep >= 5): multiply
        # localMalus^zeroCov, clamped to at least 1/partBonus (reference
        # exonmodel.cc:1838-1848, extrinsicinfo.cc:1912,2371)
        lm5 = nep >= 5
        if lm5.any():
            ccov = self.cumcov_cp_plus if fwd else self.cumcov_cp_minus
            n = self.n
            e_c = np.clip(ebx, 0, n - 1)
            zc = ccov[e_c] - np.where(bob > 0,
                                      ccov[np.clip(bob - 1, 0, n - 1)], 0)
            lpm = np.where(zc > 0, zc * self.log_local_malus_cp, 0.0)
            lpm = np.maximum(lpm, -part_bonus)
            quot += np.where(lm5, lpm, 0.0)
        ln_ep = exon_len - num_ep
        ln_cp = exon_len - num_cp
        quot += np.where(ln_ep > 0, ln_ep * lm["exonpart"], 0.0)
        quot += np.where(ln_cp > 0, ln_cp * lm["CDSpart"], 0.0)
        quot += np.where(~exon_support, lm["exon"], 0.0)
        quot += np.where(~cds_support, lm["CDS"], 0.0)
        return quot

    # ------------------------------------------------------------------
    def _rest_seq(self, t: ST, c: int, g: ExonGeometry, bs: np.ndarray,
                  right, frame_of_right: int) -> np.ndarray:
        """`right` may be a scalar (one exon end, vector of begins — the
        DP candidate case) or a per-element vector paired with bs (the
        pinned-state precompute, device._build_pinned)."""
        cn, n = self.cn, self.n
        k = self.exp.k
        codes = self.codes
        log_nc = float(np.log(cn.prob_n_in_coding))
        out = np.full(bs.shape[0], NEG_INF)
        pls = self.exp.gc[c].pls
        rightv = np.broadcast_to(
            np.asarray(right, dtype=np.int64), bs.shape)

        over = bs > rightv
        out[over] = (bs[over] - rightv[over] - 1) * LOG4

        shorts = (~over) & (rightv - bs <= k)
        if shorts.any():
            for i in np.flatnonzero(shorts):
                b = int(bs[i])
                ri = int(rightv[i])
                l = ri - b
                if g.forward:
                    ids = genetics.kmer_ids(codes[b: ri + 1], l + 1)
                    frame = frame_of_right
                else:
                    ids = genetics.rc_kmer_ids(codes[b: ri + 1], l + 1)
                    frame = int(mod3(frame_of_right + l))
                if ids.size and ids[0] >= 0:
                    val = pls[l][frame, ids[0]]
                    out[i] = np.log(val) if val > 0 else NEG_INF
                else:
                    out[i] = (l + 1) * log_nc

        normal = (~over) & (rightv - bs > k)
        if not normal.any():
            return out
        idxs = np.flatnonzero(normal)
        b = bs[idxs]
        right = rightv[idxs]

        if g.forward:
            phi = mod3(frame_of_right - right)
            cum_emi = self.cum_exon[(c, "emi", True)]
            cum_init = self.cum_exon[(c, "init", True)]
            cum_et = self.cum_exon[(c, "et", True)]
            # initial pattern of length k at [b, b+k-1]
            end_of_start = b + k - 1
            initpat = np.full(b.shape[0], k * log_nc)
            ids = self.kmer_ids_full(k)
            sel_ok = (b >= 0) & (b <= n - k)
            pid = ids[np.clip(b, 0, max(n - k, 0))]
            frame_ip = mod3(phi + end_of_start)
            okp = sel_ok & (pid >= 0)
            vals = pls[k - 1][frame_ip[okp], pid[okp]]
            with np.errstate(divide="ignore"):
                initpat[okp] = np.log(vals)

            if t == ST.singleG:
                end_init = np.minimum(end_of_start + cn.init_coding_len, right)
                seg = T.seg_sum(cum_init, phi, b + k, end_init) + \
                    T.seg_sum(cum_emi, phi, end_init + 1, right)
            elif t in (ST.initial0, ST.initial1, ST.initial2):
                end_init = end_of_start + cn.init_coding_len
                over_r = end_init > right
                end_init = np.where(over_r, right, end_init)
                bot = np.where(over_r, right + 1,
                               right - cn.et_coding_len + 1)
                bot = np.where(bot <= end_init, right + 1, bot)
                seg = T.seg_sum(cum_init, phi, b + k, end_init) + \
                    T.seg_sum(cum_emi, phi, end_init + 1, bot - 1) + \
                    T.seg_sum(cum_et, phi, bot, right)
            elif t in (ST.internal0, ST.internal1, ST.internal2):
                bot = right - cn.et_coding_len + 1
                bot = np.where(bot <= end_of_start, right + 1, bot)
                seg = T.seg_sum(cum_emi, phi, b + k, bot - 1) + \
                    T.seg_sum(cum_et, phi, bot, right)
            else:  # terminal
                seg = T.seg_sum(cum_emi, phi, b + k, right)
            out[idxs] = initpat + seg
        else:
            phi = mod3(frame_of_right + right)
            cum_emi = self.cum_exon[(c, "emi", False)]
            cum_init = self.cum_exon[(c, "init", False)]
            cum_et = self.cum_exon[(c, "et", False)]
            begin_initp = right - (k - 1)
            # rc initial pattern of length k at [begin_initp, right]
            rids = self.rc_kmer_ids_full(k)
            initpat = np.full(b.shape[0], k * log_nc)
            ok = (begin_initp >= 0) & (begin_initp <= n - k)
            pid = rids[np.clip(begin_initp, 0, max(n - k, 0))]
            okp = ok & (pid >= 0)
            if okp.any():
                frame_ip = mod3(frame_of_right + right - begin_initp)
                vals = pls[k - 1][frame_ip[okp], pid[okp]]
                with np.errstate(divide="ignore"):
                    initpat[okp] = np.where(vals > 0, np.log(vals), NEG_INF)
            if t == ST.rsingleG:
                begin_init = np.maximum(begin_initp - cn.init_coding_len, b)
                seg = T.seg_sum(cum_init, phi, begin_init, begin_initp - 1) + \
                    T.seg_sum(cum_emi, phi, b, begin_init - 1)
            elif t == ST.rinitial:
                begin_init = begin_initp - cn.init_coding_len
                under = begin_init < b
                begin_init = np.where(under, b, begin_init)
                eot = np.where(under, b - 1, b + cn.et_coding_len - 1)
                eot = np.where((~under) & (eot >= begin_init), b - 1, eot)
                seg = T.seg_sum(cum_init, phi, begin_init, begin_initp - 1) + \
                    T.seg_sum(cum_emi, phi, eot + 1, begin_init - 1) + \
                    T.seg_sum(cum_et, phi, b, eot)
            elif t in (ST.rinternal0, ST.rinternal1, ST.rinternal2):
                eot = b + cn.et_coding_len - 1
                eot = np.where(eot >= begin_initp, b - 1, eot)
                seg = T.seg_sum(cum_emi, phi, eot + 1, begin_initp - 1) + \
                    T.seg_sum(cum_et, phi, b, eot)
            else:  # rterminal*
                seg = T.seg_sum(cum_emi, phi, b, begin_initp - 1)
            out[idxs] = initpat + seg
        return out

