"""High-level prediction entry points: sequences in, GFF text out.

Port of `augustus_tpu/predict.py` for ab-initio Viterbi gene prediction
(reference flow augustus.cc predictOnInputSequences ->
NAMGene::doViterbiPiecewise -> getStepGenes -> findGenes).  Each piece is
decoded by host track preparation (engine/gold, device, scan, pack), the
Viterbi kernel on `device` (engine/viterbi.py) and the host traceback.
Pieces decode in order.

Outside this slice, and raising NotImplementedError: UTR and ncRNA
architectures, softmasking, hints, sampling (--sample, --mea,
--alternatives-from-sampling), evidence output and GenBank evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import genetics, stats
from .constants import Constants
from .properties import Properties, init_properties, parse_bool
from .model.state_config import parse_state_config, StateGraph, ST
from .model import pbl, gc as gcmod
from .engine.gold import GoldEngine
from .io.fasta import FastaRecord, read_fasta
from .output import genes as og


def resolve_device(device=None) -> torch.device:
    """The device to decode on: `cuda` unless the caller asks otherwise.
    Raises when CUDA is asked for (or defaulted to) and absent: the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions of the kernels")
    return dev


@dataclass
class Model:
    """A loaded species model (parameters + topology + constants)."""
    props: Properties
    cn: Constants
    sg: StateGraph
    igp: pbl.IgenicParams
    exp: pbl.ExonParams
    inp: pbl.IntronParams
    decomp: gcmod.Decomposition
    gcode: genetics.GeneticCode

    @classmethod
    def load(cls, args: dict, config_path: Optional[str] = None) -> "Model":
        for key in ("UTR", "nc"):
            if parse_bool(str(args.get(key, "off"))):
                raise NotImplementedError(
                    "not ported yet: UTR / ncRNA models (--UTR=off)")
        props = init_properties(args, config_path)
        cn = Constants.from_properties(props)
        _check_scope(props, cn)
        sg = parse_state_config(props)
        if any(mc != "igenicmodel" and mc != "exonmodel"
               and mc != "intronmodel" for mc in sg.model_class):
            raise NotImplementedError(
                "UTR / ncRNA state architectures are not ported yet")
        igp = pbl.read_igenic_pbl(props.species_file("_igenic_probs.pbl"),
                                  cn.decomp_num_steps)
        exp = pbl.read_exon_pbl(props.species_file("_exon_probs.pbl"),
                                cn.decomp_num_steps, cn,
                                k=props.get_int("/ExonModel/k", 4))
        inp = pbl.read_intron_pbl(props.species_file("_intron_probs.pbl"),
                                  cn.decomp_num_steps, cn, props)
        decomp = gcmod.make_decomposition(cn, props)
        table = props.get_int("translation_table", 1)
        return cls(props=props, cn=cn, sg=sg, igp=igp, exp=exp, inp=inp,
                   decomp=decomp, gcode=genetics.GeneticCode(table))


def _check_scope(props: Properties, cn: Constants) -> None:
    """Raise for every request this slice of the port does not cover."""
    missing = []
    if props.get_bool("UTR", False) or props.get_bool("nc", False):
        missing.append("UTR / ncRNA models (--UTR=off)")
    if cn.softmasking:
        missing.append("softmasking (--softmasking=0)")
    if "hintsfile" in props:
        missing.append("hints (--hintsfile)")
    if props.get_int("sample", 0) > 1 or props.get_bool("mea", False):
        missing.append("sampling / MEA (--sample, --mea)")
    if props.get_bool("alternatives-from-sampling", False) or \
            props.get_bool("alternatives-from-evidence", False):
        missing.append("alternative transcripts")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def _strand_option(props) -> str:
    """reference augustus.cc:178-190 strand string parsing."""
    s = props.get("strand", "") or ""
    if s in ("forward", "Forward", "plus", "Plus", "+", "Watson",
             "watson", "w"):
        return "+"
    if s in ("backward", "Backward", "minus", "Minus", "-", "Crick",
             "crick", "c", "reverse", "Reverse"):
        return "-"
    return "both"


def _decode(gold: GoldEngine, codes, device: torch.device):
    """One Viterbi decode; returns the condensed PathState list."""
    from .engine.device import build_tracks
    from .engine.viterbi import ViterbiEngine
    with stats.stage("prep"):
        gold.prepare(codes)
    with stats.stage("build_tracks"):
        tracks = build_tracks(gold)
    with stats.stage("pack"):
        eng = ViterbiEngine(tracks, device)
    eng.run()
    with stats.stage("traceback"):
        return eng.traceback_path(codes.shape[0])


def _new_gold(model: Model, init_synch: bool, term_synch: bool) -> GoldEngine:
    gold = GoldEngine(model.sg, model.cn, model.igp, model.exp, model.inp,
                      model.decomp, model.gcode)
    gold.set_boundaries(init_synch, term_synch)
    return gold


def _find_genes(model: Model, codes: np.ndarray, device: torch.device,
                init_synch: bool = False, term_synch: bool = False):
    """Viterbi decode + gene projection + filtering on one sequence piece
    (reference NAMGene::findGenes, namgene.cc:763, Viterbi-only branch)."""
    cn = model.cn
    props = model.props
    path = _decode(_new_gold(model, init_synch, term_synch), codes, device)
    with stats.stage("project"):
        genes = og.project_onto_genes(path, cn)
        for g in genes:
            g.apostprob = 1.0
            g.set_state_postprobs(1.0)
            g.set_sample_count(1)
            g.has_probs = True
            g.throwaway = False
            g.viterbi = True
        keep_viterbi = props.get_bool("keep_viterbi", False)
        genes = og.filter_transcripts(
            genes, codes, cn, model.gcode, strand=_strand_option(props),
            no_in_frame_stop=props.get_bool("noInFrameStop", False),
            keep_viterbi=keep_viterbi,
            minexonintronprob=props.get_float("minexonintronprob", 0.0),
            minmeanexonintronprob=props.get_float("minmeanexonintronprob",
                                                  0.0))
        genes = og.max_tracks_order(genes, keep_viterbi=keep_viterbi)
        agl = og.group_transcripts(genes)
        agl.sort(key=lambda ag: ag.mincodstart)  # AltGene::operator<
        # reference findGenes else-branch (namgene.cc:945-952)
        for ag in agl:
            for tx in ag.transcripts:
                tx.has_probs = False
                tx.set_state_has_score(False)
        for ag in agl:
            og.sort_transcripts(ag)
    return agl


def _try_find_cut(path, exam_start: int, exam_end: int, gaps,
                  only_internal: bool):
    """reference NAMGene::tryFindCutEndPoint (namgene.cc): center of the
    largest intersection of a predicted intergenic region with a gap."""
    if gaps is None:
        gaps = [(0, 2**31 - 1)]
    max_b, max_e = -1, -1
    for i, st in enumerate(path):
        if st.type != ST.igenic:
            continue
        irb = exam_start + st.begin
        ire = exam_start + st.end
        lgb, lge = -1, -1
        for (gs, ge) in gaps:
            if gs < irb and ge <= ire and ge >= irb and ge - irb > lge - lgb:
                lgb, lge = irb, ge
            elif gs < irb and ge > ire and ire - irb > lge - lgb:
                lgb, lge = irb, ire
            elif gs > irb and ge < ire and ge - gs > lge - lgb:
                lgb, lge = gs, ge
            elif gs >= irb and gs <= ire and ge >= ire and ire - gs > lge - lgb:
                lgb, lge = gs, ire
        internal = 0 < i < len(path) - 1
        if lge - lgb > max_e - max_b and (
                internal or not only_internal or
                lge - lgb > (exam_end - exam_start) // 2):
            max_b, max_e = lgb, lge
    if max_e - max_b > 0:
        return (max_e + max_b) // 2
    return -1


def _next_cut_end_point(model, codes, begin: int, maxstep: int, device,
                        mini_init_synch: bool, mini_term_synch: bool) -> int:
    """reference NAMGene::getNextCutEndPoint (namgene.cc:973), without
    hint group gaps (ab initio: one gap spanning the sequence)."""
    n = codes.shape[0]
    restlen = n - begin
    if restlen <= maxstep:
        return begin + restlen - 1
    exam = 50000
    if exam < 0.2 * maxstep:
        exam = int(0.2 * maxstep)
    if exam > 150000:
        exam = 150000
    gaps_in_range = [(gs, ge) for (gs, ge) in [(1, n - 1)]
                     if ge > begin and gs <= begin + maxstep]

    def exam_interval(chunk, gaps_r, skip_last):
        if gaps_r:
            idx = len(gaps_r) - 1
            if skip_last and idx > 0:
                idx -= 1
            gs, ge = gaps_r[idx]
            if ge - gs < chunk:
                center = (ge + gs) // 2
            else:
                center = ge - chunk // 2
        else:
            center = begin + maxstep - 1
        if chunk > maxstep:
            return begin, begin + maxstep - 1
        s = center - chunk // 2
        e = center + chunk // 2
        if e >= begin + maxstep:
            s -= e - (begin + maxstep - 1)
            e = begin + maxstep - 1
        if s < begin:
            e += begin - s
            s = begin
        return s, e

    def run_exam(s, e):
        gold = _new_gold(model, mini_init_synch, mini_term_synch)
        return _decode(gold, codes[s: e + 1], device)

    s, e = exam_interval(exam, gaps_in_range, skip_last=False)
    path = run_exam(s, e)
    cut = _try_find_cut(path, s, e, gaps_in_range, True)
    if cut == -1:
        # 2nd try: double the window, last-but-one gap, relaxed criteria
        exam = min(exam * 2, maxstep)
        skip_last = bool(gaps_in_range) and gaps_in_range[-1][0] >= s
        s, e = exam_interval(exam, gaps_in_range, skip_last=skip_last)
        path = run_exam(s, e)
        cut = _try_find_cut(path, s, e, gaps_in_range, True)
        if cut == -1:
            cut = _try_find_cut(path, s, e, gaps_in_range, False)
        if cut == -1:
            cut = _try_find_cut(path, s, e, None, False)
        if cut == -1:
            cut = begin + maxstep - 1
    if cut <= begin + 0.05 * maxstep or cut <= begin + 5000:
        cut = begin + maxstep - 1   # move by at least 5% and 5000bp
    return cut


def predict_sequence(model: Model, rec: FastaRecord, seq_number: int = 1,
                     geneid_start: int = 1, device=None,
                     with_header: bool = True) -> tuple:
    """Predict genes on one sequence; returns (gff_text, n_genes,
    transcripts).  Long sequences are decoded piecewise (reference
    NAMGene::doViterbiPiecewise, namgene.cc:524): cut points are searched
    in predicted intergenic regions, and interior piece boundaries are
    forced through the synchronisation (igenic) state."""
    device = resolve_device(device)
    props = model.props
    codes = genetics.encode(rec.sequence.lower())

    # --predictionStart/--predictionEnd: cut the relevant piece and shift
    # output coordinates (reference augustus.cc cutRelevantPiece)
    seqlen = codes.shape[0]
    pstart = props.get_int("predictionStart", 1) - 1 \
        if "predictionStart" in props else 0
    pend = props.get_int("predictionEnd", seqlen) - 1 \
        if "predictionEnd" in props else seqlen - 1
    offset = 0
    if (pstart != 0 or pend != seqlen - 1) and not (pend < 0 and pstart < 0):
        pstart = max(pstart, 0)
        pend = min(pend, seqlen - 1)
        if pstart >= seqlen:
            raise ValueError("predictionStart is larger than sequence length")
        if pend < pstart:
            raise ValueError("predictionEnd is smaller than predictionStart")
        codes = codes[pstart: pend + 1]
        offset = pstart
    elif pstart < 0 and pend == pstart:
        offset = -pstart - 1

    n = codes.shape[0]
    maxstep = props.get_int("maxDNAPieceSize", 2000000)
    if maxstep < 1000:
        maxstep = 1000

    bodies: List[str] = []
    all_transcripts: List[og.Gene] = []
    gid = geneid_start
    total = 0
    o = og.OutputOptions.from_properties(props)
    # the cut-point mini-viterbi inherits the boundary distributions set
    # for the PREVIOUS piece (reference quirk, namgene.cc:576-604)
    prev_init_synch = prev_term_synch = False
    pieces = []
    begin = 0
    while begin < n:
        end = _next_cut_end_point(model, codes, begin, maxstep, device,
                                  prev_init_synch, prev_term_synch)
        init_synch = begin > 0
        term_synch = end < n - 1
        pieces.append((begin, end, init_synch, term_synch))
        prev_init_synch, prev_term_synch = init_synch, term_synch
        begin = end + 1

    for (begin, end, init_synch, term_synch) in pieces:
        agl = _find_genes(model, codes[begin: end + 1], device, init_synch,
                          term_synch)
        for ag in agl:
            ag.shift_coordinates(begin + offset)
            ag.id = f"g{gid}"
            ag.seqname = rec.name
            gid += 1
            tid = 1
            for tx in ag.transcripts:
                tx.seqname = rec.name
                tx.id = f"t{tid}"
                tx.geneid = ag.id
                tid += 1
                all_transcripts.append(tx)
        total += len(agl)
        if agl:
            with stats.stage("print"):
                bodies.append(og.print_gene_list(agl, codes, o, model.gcode,
                                                 seq_offset=offset))

    header = [
        "#",
        f"# ----- prediction on sequence number {seq_number} "
        f"(length = {n}, name = {rec.name}) -----",
        "#",
        f"# Predicted genes for sequence number {seq_number} on "
        + {"+": "forward strand", "-": "reverse strand",
           "both": "both strands"}[_strand_option(props)],
    ]
    body = "".join(bodies)
    if total == 0:
        body = "# (none)\n"
    if not with_header:
        return body, total, all_transcripts
    return "\n".join(header) + "\n" + body, total, all_transcripts


def predict_records(model: Model, recs: List[FastaRecord], device=None) -> str:
    """GFF text for a list of sequences (gene ids continue across them)."""
    device = resolve_device(device)
    chunks = []
    gid = 1
    for i, rec in enumerate(recs):
        text, ngenes, _ = predict_sequence(model, rec, seq_number=i + 1,
                                           geneid_start=gid, device=device)
        gid += ngenes
        chunks.append(text)
    return "".join(chunks)


def predict_file(model: Model, path: str, device=None) -> str:
    device = resolve_device(device)
    recs = read_fasta(path)
    props = model.props
    if recs and ("predictionStart" in props or "predictionEnd" in props):
        # reference cutRelevantPiece: with an actual cut, only the first
        # sequence is predicted (augustus.cc:581)
        seqlen = len(recs[0].sequence)
        ps = props.get_int("predictionStart", 1) - 1 \
            if "predictionStart" in props else 0
        pe = props.get_int("predictionEnd", seqlen) - 1 \
            if "predictionEnd" in props else seqlen - 1
        if (ps != 0 or pe != seqlen - 1) and not (pe < 0 and ps < 0):
            recs = recs[:1]
    return predict_records(model, recs, device)
