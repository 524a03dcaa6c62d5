"""Track preparation for the semi-Markov decode.

Counterpart of `augustus_tpu/engine/gold.py` less its float64 host DP
(`run`, `traceback`): the decode runs in engine/viterbi.py.
`GoldEngine.prepare`, `_prepare_tracks`, `_build_hint_tracks`,
`_apply_signal_hint_terms` and `set_boundaries` build float64 tracks of ORF
barriers, splice scores, content cumsums, signal sensors and the hint
bonus/malus terms of softmasking and hints files, which engine/device.py
factorizes into the DP tracks.  `prepare` is the host route (numpy);
`_prepare_tracks` and the track builders under it also run on torch
tensors for the device route (engine/jgold.py, xputil.use_torch).
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
                 utr=None, utr_cfg=None, ext_cfg=None):
        self.sg = sg
        self.cn = cn
        self.igp = igp
        self.exp = exp
        self.inp = inp
        self.decomp = decomp
        self.gcode = gcode or genetics.GeneticCode()
        self.utr = utr              # UtrParams or None
        self.utr_cfg = utr_cfg      # UtrConfig or None
        self.ext_cfg = ext_cfg      # ExtrinsicConfig or None
        self.S = sg.statecount
        self.utr_states = [(i, t) for i, t in enumerate(sg.state_types)
                           if sg.model_class[i] == "utrmodel"]
        if self.utr_states and utr is None:
            raise ValueError("architecture contains UTR states but no UTR "
                             "parameters were loaded")

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
        if self.utr is not None and self.utr_states:
            from . import gold_utr
            gold_utr.prepare_utr(self, self.codes)
        if any(mc == "ncmodel" for mc in self.sg.model_class):
            from . import gold_nc
            gold_nc.prepare_nc(self, self.codes)

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














