"""Host track preparation for the semi-Markov Viterbi decode.

Host copy of the preparation half of `augustus_tpu/engine/gold.py`
(`GoldEngine.prepare`, `_prepare_tracks`, `set_boundaries`): float64 numpy
tracks of ORF barriers, splice scores, content cumsums and signal sensors,
which engine/device.py factorizes into the DP tracks.  The float64 host DP
of the reference package (`run`, `traceback`, sampling) is not part of this
package: the decode runs in engine/viterbi.py.
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
                 gcode: Optional[genetics.GeneticCode] = None):
        self.sg = sg
        self.cn = cn
        self.igp = igp
        self.exp = exp
        self.inp = inp
        self.decomp = decomp
        self.gcode = gcode or genetics.GeneticCode()
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
        """Precompute all tracks for one sequence.

        softmask / gff_hints: accepted for the reference signature; a
        softmasked run (softmasking on) or any hints raise
        NotImplementedError, as that machinery is not ported yet.
        """
        cn, n = self.cn, codes.shape[0]
        if (softmask is not None and cn.softmasking) or gff_hints is not None:
            raise NotImplementedError(
                "softmasking and hints are not ported yet "
                "(run with --softmasking=0 and no hints file)")
        self.codes = codes
        self.n = n
        self._kmer_full: Dict[tuple, np.ndarray] = {}
        self.stairs = gcmod.compute_stairs(codes, cn, self.decomp)
        self._prepare_tracks(codes)

    # ------------------------------------------------------------------
    def _prepare_tracks(self, codes: np.ndarray) -> None:
        """Sequence-content track building (ORF barriers, splice scores,
        content cumsums, signal sensors) in float64 numpy."""
        from . import xputil as U
        xp = np
        cn, n = self.cn, self.n
        self.orf = T.nearest_stop_arrays(codes, self.gcode)
        self.splice = T.build_splice_tracks(codes, self.inp, cn)

        k = self.exp.k
        log_n_coding = float(np.log(cn.prob_n_in_coding))
        classes = list(range(len(self.inp.gc)))
        self.classes = classes

        def cum0(x):
            c = U.DD.cumsum_dd(xp.concatenate(
                [xp.zeros(1, dtype=U.ftype()), x]))
            return c.hi

        # content tracks per class
        self.ig_track: Dict[int, np.ndarray] = {}
        self.intron_f: Dict[int, np.ndarray] = {}
        self.intron_r: Dict[int, np.ndarray] = {}
        self.cum_intron_f: Dict[int, np.ndarray] = {}
        self.cum_intron_r: Dict[int, np.ndarray] = {}
        self.cum_exon: Dict[Tuple[int, str, bool], np.ndarray] = {}
        for c in classes:
            self.ig_track[c] = self._igenic_track(codes, c)
            # kmer_lookup_log already yields LOG_QUARTER below k = k1-1
            itf = T.kmer_lookup_log(codes, self.inp.k + 1,
                                    self.inp.gc[c].emiprobs, T.LOG_QUARTER)
            itr = T.rc_kmer_lookup_log(codes, self.inp.k + 1,
                                       self.inp.gc[c].emiprobs, T.LOG_QUARTER)
            self.intron_f_nb = getattr(self, "intron_f_nb", {})
            self.intron_f_nb[c] = itf
            self.intron_f[c] = itf
            self.intron_r[c] = itr
            self.cum_intron_f[c] = cum0(itf)
            self.cum_intron_r[c] = cum0(itr)

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
                self.cum_exon[(c, name, True)] = T.phase_cumsum(per_frame_f,
                                                                reverse=False)
                self.cum_exon[(c, name, False)] = T.phase_cumsum(per_frame_r,
                                                                 reverse=True)

        # signal tracks
        self._build_signal_tracks(codes)

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
        xp = np
        tied = (cn.tie_igenic_intron and self.inp.gc
                and self.inp.gc[c].emiprobs.size > 0 and self.inp.k == k)
        table = self.inp.gc[c].emiprobs if tied else igp.gc[c].emiprobs
        out = T.kmer_lookup_log(codes, k + 1, table, T.LOG_QUARTER)
        # j <= k prefix: conditional short-pattern probabilities, replicating
        # the reference sibling-index arithmetic (static loop)
        n_ = codes.shape[0]
        pls = igp.gc[c].pls
        head = []
        for j in range(min(k + 1, n_)):
            window = codes[: j + 1].astype(np.int64)
            bad = (window == genetics.N).any()
            idx = xp.zeros((), dtype=np.int64 if xp is np else np.int32)
            for bi in range(j + 1):
                idx = (idx << 2) | xp.where(window[bi] == genetics.N, 0,
                                            window[bi])
            vals = U.asarr(pls[j])
            sz = pls[j].size
            denom_base = idx // 4
            denom = (vals[denom_base]
                     + vals[xp.minimum(denom_base + 1, sz - 1)]
                     + vals[xp.minimum(denom_base + 2, sz - 1)]
                     + vals[xp.minimum(denom_base + 3, sz - 1)])
            vi = vals[idx]
            good = (~bad) & (denom > 0) & (vi > 0)
            val = xp.where(good,
                           T._safe_log(xp.where(good, vi, 1.0) /
                                       xp.where(denom > 0, denom, 1.0)),
                           T.LOG_QUARTER)
            head.append(xp.reshape(val, (1,)))
        if head:
            out = xp.concatenate([xp.concatenate(head),
                                  out[len(head):]])
        return out

    # ------------------------------------------------------------------
    def _build_signal_tracks(self, codes: np.ndarray) -> None:
        from . import xputil as U
        xp = np
        cn, n = self.cn, self.n
        gcode = self.gcode
        cds = codes

        # stop-codon endPart for terminal/singleG ending at DP base j:
        # stop codon at stppos = j-2 (reference exonmodel.cc:1276-1311)
        c64 = cds.astype(np.int64)
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
            self.stop_at_log = np.full(max(n - 2, 0), NEG_INF)
            stop_log = np.full(n, NEG_INF)
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
            rstop = np.full(n, NEG_INF)
        self.begin_rstop = rstop

        # start codons
        start_prob = np.zeros(64)
        probs_src = self.exp.start_codon_probs
        if probs_src:
            for pn, p in probs_src.items():
                start_prob[pn] = p
        else:
            start_prob[14] = 1.0   # atg
        start_prob_t = U.asarr(start_prob)
        if n >= 3:
            cod = (c64[:-2] * 16 + c64[1:-1] * 4 + c64[2:])
            valid = (c64[:-2] != genetics.N) & (c64[1:-1] != genetics.N) & \
                (c64[2:] != genetics.N)
            sf = xp.where(valid,
                          T._safe_log(start_prob_t[xp.where(valid, cod, 0)]),
                          NEG_INF)
            tail2 = xp.full(2, NEG_INF, dtype=U.ftype())
            start_fwd = xp.concatenate([sf, tail2])
            # reverse: codon read as rc of [pos, pos+2]
            comp = U.asarr(genetics.COMPLEMENT)[cds].astype(np.int64)
            rcod = comp[2:] * 16 + comp[1:-1] * 4 + comp[:-2]
            sr = xp.where(valid,
                          T._safe_log(start_prob_t[xp.where(valid, rcod, 0)]),
                          NEG_INF)
            start_rev = xp.concatenate([sr, tail2])
        else:
            start_fwd = np.full(n, NEG_INF)     # atg starting at pos
            start_rev = np.full(n, NEG_INF)     # 'cat' starting at pos

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
                binned = T._safe_log(tb.factor(xp.exp(xp.where(ok, val,
                                                               0.0))))
                val = xp.where(ok, binned, val)
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
                binned = T._safe_log(tb.factor(xp.exp(xp.where(okv, val,
                                                               0.0))))
                val = xp.where(okv, binned, val)
            self.tis_end_rev[c] = val

        self.start_fwd_log = start_fwd

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
