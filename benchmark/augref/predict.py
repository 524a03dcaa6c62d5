"""The reference's decode of one piece: the plain Viterbi recursion, gene
projection and printing, on the CPU.

A frozen copy of the parts of the program's `predict.py` that decode one
sequence piece on its device route (`_find_genes`): the species model
(`Model.load`, the configuration's files), the piece's tracks (hint
collection, `engine/device_prep.py`'s preparation with the plain version
of `prefix.cu`, `engine/device.py`, `engine/pack.py`), the plain version
of the 64-state recursion (`engine/viterbi.py`) and of the event walk
(`engine/traceback.py`), gene projection, filtering and grouping
(`output/genes.py`) and the evidence of hinted pieces
(`output/evidence.py`).  Sampling, MEA, the UTR and nc architectures, the
general recursion of more than 64 states and the cutting of a sequence
into pieces are not part of the reference: the windows of the check
(benchlib/correct.py) start where the program's pieces start.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import genetics, stats
from .constants import Constants
from .properties import Properties, init_properties
from .model.state_config import StateGraph, parse_state_config
from .model import pbl, gc as gcmod
from .engine.gold import GoldEngine
from .hints import config as hints_config
from .hints import system as hints_system
from .output import evidence as ev
from .output import genes as og


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
    utr: object = None           # model.pbl.UtrParams (UTR architectures)
    utr_cfg: object = None       # engine.gold_utr.UtrConfig
    ext_cfg: object = None       # hints.config.ExtrinsicConfig or None
    gff_hints: object = None     # {seqname: [Feature]} of --hintsfile
    # "auto": each piece on the route augustus_tpu chooses; "host": every
    # piece on the host route (to compare the two routes)
    route: str = "auto"

    @classmethod
    def load(cls, args: dict, config_path: Optional[str] = None) -> "Model":
        props = init_properties(args, config_path)
        cn = Constants.from_properties(props)
        sg = parse_state_config(props)
        if any(mc in ("utrmodel", "ncmodel") for mc in sg.model_class):
            raise NotImplementedError("the reference decodes neither UTR "
                                      "nor ncRNA architectures")
        igp = pbl.read_igenic_pbl(props.species_file("_igenic_probs.pbl"),
                                  cn.decomp_num_steps)
        exp = pbl.read_exon_pbl(props.species_file("_exon_probs.pbl"),
                                cn.decomp_num_steps, cn,
                                k=props.get_int("/ExonModel/k", 4))
        inp = pbl.read_intron_pbl(props.species_file("_intron_probs.pbl"),
                                  cn.decomp_num_steps, cn, props)
        decomp = gcmod.make_decomposition(cn, props)
        table = props.get_int("translation_table", 1)
        utr = utr_cfg = None
        ext_cfg = gff_hints = None
        path = hints_config.default_config_path(props)
        if path is not None and (cn.softmasking or "hintsfile" in props):
            ext_cfg = hints_config.read_extrinsic_cfg(path)
        if "hintsfile" in props and ext_cfg is not None:
            intron_geo = 1.0 - 1.0 / inp.gc[0].mal if inp.gc else None
            gff_hints = hints_system.parse_gff_hints(
                props.get("hintsfile"), ext_cfg, intron_geo=intron_geo,
                pred_start=(props.get_int("predictionStart")
                            if "predictionStart" in props else None),
                pred_end=(props.get_int("predictionEnd")
                          if "predictionEnd" in props else None))
        return cls(props=props, cn=cn, sg=sg, igp=igp, exp=exp, inp=inp,
                   decomp=decomp, gcode=genetics.GeneticCode(table),
                   utr=utr, utr_cfg=utr_cfg, ext_cfg=ext_cfg,
                   gff_hints=gff_hints)


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


def _engine(gold: GoldEngine, codes, softmask, gff_hints,
            device: torch.device, route: str = "auto"):
    """The plain Viterbi engine of the piece's route, its tables prepared
    and not yet run: the device route's preparation where it takes the
    piece, else the host route's tracks; the 64-state recursion either
    way."""
    from .engine.device import build_tracks
    from .engine.device_prep import device_engine
    from .engine.pack import pack_tracks
    from .engine.scan import needs_general_scan
    from .engine.viterbi import ViterbiEngine, k1_fits
    if _auto_route(route):
        eng = device_engine(gold, codes, softmask, gff_hints, device)
        if eng is not None:
            stats.count("device_prep")
            return eng
    else:
        with stats.stage("prep"):
            gold.collect_hints(codes, softmask, gff_hints)
    stats.count("host_prep")
    with stats.stage("prep"):
        gold.prepare_collected()
    with stats.stage("build_tracks"):
        tracks = build_tracks(gold)
    with stats.stage("pack"):
        packed = None if needs_general_scan(tracks) else pack_tracks(tracks)
        if packed is None or not k1_fits(*packed):
            raise NotImplementedError("a piece past the 64-state "
                                      "recursion's capacity")
        return ViterbiEngine(tracks, device, packed)


def _decode(gold: GoldEngine, codes, softmask, gff_hints,
            device: torch.device, route: str = "auto"):
    """One Viterbi decode: the condensed PathState list by the event
    walk."""
    eng = _engine(gold, codes, softmask, gff_hints, device, route)
    eng.run()
    with stats.stage("traceback", eng.device):
        return eng.traceback_path(codes.shape[0])


def _auto_route(route: str) -> bool:
    """Model.route: True for "auto", False for "host"."""
    if route not in ("auto", "host"):
        raise ValueError(f"route {route!r}: 'auto' or 'host'")
    return route == "auto"


def _new_gold(model: Model, init_synch: bool, term_synch: bool) -> GoldEngine:
    gold = GoldEngine(model.sg, model.cn, model.igp, model.exp, model.inp,
                      model.decomp, model.gcode, utr=model.utr,
                      utr_cfg=model.utr_cfg, ext_cfg=model.ext_cfg)
    gold.set_boundaries(init_synch, term_synch)
    return gold


@dataclass
class Sampling:
    """The reference's sampling configuration (namgene.cc:54-92,768), as
    augustus_tpu/predict.py:200-219 reads it."""
    iters: int                 # 1: the Viterbi path only
    alternatives: bool         # --alternatives-from-sampling
    minexonintronprob: float
    minmeanexonintronprob: float
    mea: bool

    @classmethod
    def from_properties(cls, props: Properties) -> "Sampling":
        iters = props.get_int("sample", 0)
        if 0 < iters < 10:
            iters = 0          # reference refuses too-low sample counts
        s = cls(iters, props.get_bool("alternatives-from-sampling", False),
                props.get_float("minexonintronprob", 0.0),
                props.get_float("minmeanexonintronprob", 0.0),
                props.get_bool("mea", False))
        if s.mea:
            # reference namgene.cc:85-90: MEA forces sampling and turns the
            # probability filters off
            s.iters, s.alternatives = 100, True
            s.minexonintronprob = s.minmeanexonintronprob = 0.0
        s.iters = max(s.iters, 1)
        return s


def _mark(genes, viterbi: bool, throwaway: bool) -> None:
    """A new transcript's weight 1 (reference findGenes)."""
    for g in genes:
        g.apostprob = 1.0
        g.set_state_postprobs(1.0)
        g.set_sample_count(1)
        g.has_probs = True
        g.throwaway = throwaway
        g.viterbi = viterbi


def _find_genes(model: Model, codes: np.ndarray, softmask, gff_hints,
                device: torch.device, init_synch: bool = False,
                term_synch: bool = False):
    """Viterbi decode, gene projection and filtering on one sequence piece
    (reference NAMGene::findGenes, namgene.cc:763); returns (agl,
    with_evidence) in piece-local coordinates."""
    cn = model.cn
    props = model.props
    sampling = Sampling.from_properties(props)
    if sampling.iters > 1 or sampling.mea:
        raise NotImplementedError("the reference does not sample")
    gold = _new_gold(model, init_synch, term_synch)
    path = _decode(gold, codes, softmask, gff_hints, device, model.route)
    with stats.stage("project"):
        genes = og.project_onto_genes(path, cn)
        _mark(genes, viterbi=True, throwaway=False)
    with stats.stage("project"):
        keep_viterbi = props.get_bool("keep_viterbi", False)
        genes = og.filter_transcripts(
            genes, codes, cn, model.gcode, strand=_strand_option(props),
            no_in_frame_stop=props.get_bool("noInFrameStop", False),
            keep_viterbi=keep_viterbi,
            minexonintronprob=sampling.minexonintronprob,
            minmeanexonintronprob=sampling.minmeanexonintronprob)
    with stats.stage("project"):
        genes = og.max_tracks_order(genes, keep_viterbi=keep_viterbi)
    with stats.stage("project"):
        agl = og.group_transcripts(genes)
        agl.sort(key=lambda ag: ag.mincodstart)  # AltGene::operator<
        # reference findGenes else-branch (namgene.cc:945-952)
        for ag in agl:
            for tx in ag.transcripts:
                tx.has_probs = False
                tx.set_state_has_score(False)
        for ag in agl:
            og.sort_transcripts(ag)
    # evidence is compiled in piece-local coordinates (reference
    # joinGenesFromPredRuns, extrinsicinfo.cc:1553)
    with_evidence = gold.has_hints or gff_hints is not None
    if with_evidence:
        groups = gold.hints.groups if gold.hints is not None else []
        for ag in agl:
            for tx in ag.transcripts:
                ev.compile_evidence(tx, groups)
    return agl, with_evidence


def _piece_hints(gff_hints, begin: int, end: int):
    """Subset + shift hints for a sequence piece (reference
    SequenceFeatureCollection piece constructor, extrinsicinfo.cc: keep
    features whose END lies in [begin, end], shift by -begin)."""
    if gff_hints is None:
        return None
    out = []
    for f in gff_hints:
        if begin <= f.end <= end:
            g = copy.copy(f)
            g.start -= begin
            g.end -= begin
            out.append(g)
    return out
