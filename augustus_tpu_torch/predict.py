"""High-level prediction entry points: sequences in, GFF text out.

Port of `augustus_tpu/predict.py` for Viterbi gene prediction, ab initio
or with softmasking (--softmasking=1) and a hints file (--hintsfile,
--extrinsicCfgFile) (reference flow augustus.cc predictOnInputSequences ->
NAMGene::doViterbiPiecewise -> getStepGenes -> findGenes).  Each piece is
decoded on one of two routes, chosen as augustus_tpu chooses them:

* the device route (engine/device_prep.py) for every piece without
  exon/CDS-kind hints: tracks built on `device` from the codes, the
  GC-class stairs and the hint overlays, the Viterbi kernel, the event walk
  on `device`;
* the host route otherwise: host track preparation (engine/gold, device,
  scan, pack), the Viterbi kernel on `device` (engine/viterbi.py) and the
  event walk on `device`.

With --UTR=on (the 71-state architecture, model/pbl.read_utr_pbl and
engine/gold_utr.py) every piece takes the host route and the general
Viterbi kernel K2 (engine/scan.py), as augustus_tpu sends such pieces to
its scan engine; the output gains tss/tts lines and, with --print_utr=on,
5'-UTR/3'-UTR lines.  Sampled or MEA, such a piece takes its forward table
from K5, K2's logsumexp twin over the same split tables.

`stats` counts the route of every piece, the cut-point exams (`exams`,
each timed as the stage `exam`) and the cuts (`cuts`).  Softmasked or
hinted runs print the evidence block of every transcript.  A sequence cut
into more than one piece is decoded in flight (parallel/mesh.py: one
block of a batched kernel launch per piece) unless --pieceParallel=false,
--sample or --mea; otherwise its pieces decode in order.

With --sample=N (N >= 10) a piece takes the host route, as augustus_tpu
routes it, and also fills the forward table on `device`
(engine/forward.py); the findGenes step then draws N - 1 paths from it on
the host (GoldEngine.sample_path, the glibc rand() stream of crand.py kept
on the Model), merges identical transcripts and gives every transcript and
state its posterior probability, which --alternatives-from-sampling,
--keep_viterbi, --minexonintronprob and --minmeanexonintronprob use as in
the reference; --temperature=t heats the forward table and the walk.
--mea=1 samples as --sample=100 --alternatives-from-sampling=true without
the posterior filters and keeps the transcripts of the maximum expected
accuracy path through them (output/mea.py) in place of the best-scoring
ones.  --alternatives-from-evidence is accepted and changes nothing, as in
augustus_tpu, whose prediction calls no code for it (hints/alternatives.py
is ported but, as there, not called).

evaluate_genbank predicts on the records of an annotated GenBank file
(io/genbank.py), each a sequence of its own, and prints the annotation, the
prediction and the accuracy tables (output/evaluation.py).

With --nc=on (the 83-state architecture, UTRs on) a piece takes the host
route and K2 as a UTR piece does; a noncoding transcript prints as
`noncoding_transcript` with its tss, exon and tts lines.

Outside the port so far, and raising NotImplementedError: sampling and
MEA with --nc=on.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import genetics, stats
from .crand import GlibcRand
from .constants import Constants
from .properties import Properties, init_properties
from .model.state_config import (ST, StateGraph, initial_exon_type,
                                  internal_exon_type, parse_state_config,
                                  r_internal_exon_type, r_terminal_exon_type)
from .model import pbl, gc as gcmod
from .engine.gold import GoldEngine
from .hints import config as hints_config
from .hints import system as hints_system
from .hints.features import group_gaps
from .io.fasta import FastaRecord, read_fasta
from .output import evidence as ev
from .output import genes as og
from .output.mea import get_mea_transcripts


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
    utr: object = None           # model.pbl.UtrParams (UTR architectures)
    utr_cfg: object = None       # engine.gold_utr.UtrConfig
    ext_cfg: object = None       # hints.config.ExtrinsicConfig or None
    gff_hints: object = None     # {seqname: [Feature]} of --hintsfile
    # "auto": each piece on the route augustus_tpu chooses; "host": every
    # piece on the host route (to compare the two routes)
    route: str = "auto"
    # the glibc rand() stream of the sampling walk, one per model from its
    # first sampled piece on (the reference's unseeded global rand())
    rng: Optional[GlibcRand] = None

    @classmethod
    def load(cls, args: dict, config_path: Optional[str] = None) -> "Model":
        props = init_properties(args, config_path)
        cn = Constants.from_properties(props)
        sg = parse_state_config(props)
        if any(mc == "ncmodel" for mc in sg.model_class) and (
                props.get_int("sample", 0) >= 10
                or props.get_bool("mea", False)):
            raise NotImplementedError(
                "not ported: sampling or MEA with ncRNA models (--nc=on "
                "with --sample / --mea): augustus_tpu projects no "
                "noncoding transcript (its output/genes.py:"
                "project_onto_genes does not advance past an nc exon), so "
                "there is no reference text to hold the draws to")
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
        if any(mc == "utrmodel" for mc in sg.model_class):
            from .engine.gold_utr import UtrConfig
            utr = pbl.read_utr_pbl(props.species_file("_utr_probs.pbl"),
                                   cn.decomp_num_steps, cn, props, inp)
            utr_cfg = UtrConfig.from_properties(props)
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
            device: torch.device, route: str = "auto",
            need_forward: bool = False):
    """The Viterbi engine of the piece's route (augustus_tpu/predict.py:
    113-157; route "host" forces the host route), its tables prepared and
    not yet run, and, with need_forward, the forward engine of the same
    tables: (engine, forward engine or None).  A piece of the UTR or nc
    architecture takes the host route and the general Viterbi kernel K2
    (engine/scan.py), as augustus_tpu sends it to its scan engine; the
    others the 64-state kernel K1.  need_forward (sampling): the host
    route, and K3 over K1's packing or K5 over K2's split tables
    (augustus_tpu/predict.py:140-155).

    The kernel is chosen by capacity, from the packed static before any
    launch, as augustus_tpu sends a piece its Pallas kernel cannot hold to
    its scan (pallas_pack.py:415, :423): a device-route piece that K1
    cannot hold (viterbi.k1_fits) takes the host route; a 47-state piece
    that K1 cannot hold takes K2 (bit-equal to K1 on 47 states), and a
    sampled one that K3 cannot hold (forward.k3_fits) K2 with K5.  The
    stats count each choice: k1_capacity_to_host, k1_capacity_to_k2,
    k3_capacity_to_k5."""
    from .engine.device import build_tracks
    from .engine.device_prep import device_engine
    from .engine.forward import ForwardEngine, k3_fits
    from .engine.pack import pack_tracks
    from .engine.scan import (ScanEngine, ScanForwardEngine,
                              needs_general_scan)
    from .engine.viterbi import ViterbiEngine, k1_fits
    if _auto_route(route) and not need_forward:
        eng = device_engine(gold, codes, softmask, gff_hints, device)
        if eng is not None:
            stats.count("device_prep")
            return eng, None
    else:
        with stats.stage("prep"):
            gold.collect_hints(codes, softmask, gff_hints)
    stats.count("host_prep")
    with stats.stage("prep"):
        gold.prepare_collected()
    with stats.stage("build_tracks"):
        tracks = build_tracks(gold)
    with stats.stage("pack"):
        general = needs_general_scan(tracks)
        if not general:
            packed = pack_tracks(tracks)
            if not k1_fits(*packed):
                stats.count("k1_capacity_to_k2")
                general = True
            elif need_forward and not k3_fits(*packed):
                stats.count("k3_capacity_to_k5")
                general = True
        if general:
            eng = ScanEngine(tracks, device)
            fwd = ScanForwardEngine(tracks, (eng.static, eng.arrays),
                                    device) if need_forward else None
        else:
            eng = ViterbiEngine(tracks, device, packed)
            fwd = ForwardEngine(tracks, device, (eng.static, eng.arrays)) \
                if need_forward else None
    return eng, fwd


def _decode(gold: GoldEngine, codes, softmask, gff_hints,
            device: torch.device, route: str = "auto",
            need_forward: bool = False):
    """One Viterbi decode on the piece's route (`_engine`): the condensed
    PathState list by the event walk over the plane where the kernel left
    it; with need_forward, gold.f filled with the forward table."""
    eng, fwd = _engine(gold, codes, softmask, gff_hints, device, route,
                       need_forward)
    eng.run()
    if fwd is not None:
        gold.f = fwd.run()
        gold._classify_states()
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


def _sample_transcripts(model: Model, gold: GoldEngine, genes, n: int,
                        sample_iters: int, alt_sampling: bool):
    """The Viterbi transcripts and those of sample_iters - 1 paths drawn
    from gold.f, identical ones merged, each with its posterior
    probabilities (augustus_tpu/predict.py:229-283, reference
    namgene.cc:812-905)."""
    if model.rng is None:
        model.rng = GlibcRand(1)
    alltranscripts = list(genes)
    with stats.stage("sample"):
        for _ in range(sample_iters - 1):
            spath = og.condense_path(gold.sample_path(model.rng), n)
            sampled = og.project_onto_genes(spath, model.cn)
            _mark(sampled, viterbi=False, throwaway=not alt_sampling)
            alltranscripts.extend(sampled)
    alltranscripts.sort(key=lambda g: g.gene_begin())  # stable
    # merge identical transcripts (namgene.cc:877-892)
    i = 0
    while i < len(alltranscripts):
        a = alltranscripts[i]
        j = i + 1
        while j < len(alltranscripts) and \
                alltranscripts[j].gene_begin() == a.gene_begin():
            b = alltranscripts[j]
            if a.states_equal(b):
                a.throwaway = a.throwaway and b.throwaway
                a.viterbi = a.viterbi or b.viterbi
                a.add_sample_count(1)
                a.apostprob += 1.0
                a.add_state_postprobs(1.0)
                del alltranscripts[j]
            else:
                j += 1
        i += 1
    # cross-transcript state posteriors (namgene.cc:897-905)
    for i, a in enumerate(alltranscripts):
        for b in alltranscripts[i + 1:]:
            if b.gene_begin() > a.gene_end():
                break
            a.update_post_prob(b)
    for a in alltranscripts:
        a.norm_post_prob(sample_iters)
    return alltranscripts


def _find_genes(model: Model, codes: np.ndarray, softmask, gff_hints,
                device: torch.device, init_synch: bool = False,
                term_synch: bool = False, precomputed=None):
    """Viterbi decode, sampling when asked, gene projection and filtering
    on one sequence piece (reference NAMGene::findGenes, namgene.cc:763);
    returns (agl, with_evidence) in piece-local coordinates.

    precomputed: the piece's (path, gold) from parallel.mesh.decode_pieces,
    which skips the local decode (augustus_tpu/predict.py:193-223); never
    with sampling, which needs the forward table."""
    cn = model.cn
    props = model.props
    sampling = Sampling.from_properties(props)
    need_forward = sampling.iters > 1
    if precomputed is not None:
        if need_forward:
            raise ValueError("a decoded piece cannot be sampled")
        path, gold = precomputed
    else:
        gold = _new_gold(model, init_synch, term_synch)
        path = _decode(gold, codes, softmask, gff_hints, device, model.route,
                       need_forward)
    with stats.stage("project"):
        genes = og.project_onto_genes(path, cn)
        _mark(genes, viterbi=True, throwaway=False)
    if need_forward:
        genes = _sample_transcripts(model, gold, genes, codes.shape[0],
                                    sampling.iters, sampling.alternatives)
    with stats.stage("project"):
        keep_viterbi = props.get_bool("keep_viterbi", False)
        genes = og.filter_transcripts(
            genes, codes, cn, model.gcode, strand=_strand_option(props),
            no_in_frame_stop=props.get_bool("noInFrameStop", False),
            keep_viterbi=keep_viterbi,
            minexonintronprob=sampling.minexonintronprob,
            minmeanexonintronprob=sampling.minmeanexonintronprob)
    if sampling.mea:
        # the transcripts of the maximum expected accuracy path
        # (augustus_tpu/predict.py:293-297)
        with stats.stage("mea"):
            genes = get_mea_transcripts(genes, codes, props, model.gcode)
    else:
        with stats.stage("project"):
            genes = og.max_tracks_order(genes, keep_viterbi=keep_viterbi)
    with stats.stage("project"):
        agl = og.group_transcripts(genes)
        agl.sort(key=lambda ag: ag.mincodstart)  # AltGene::operator<
        if not need_forward:
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


def _piece_input(model: Model, rec: FastaRecord, n: Optional[int]):
    """(codes, softmask, hints) of the first n bases of rec (all of it with
    n None), as predict_sequence gives a piece that starts the sequence:
    its softmask runs and the hints that end inside it."""
    seq = rec.sequence[:n]
    gff_hints = None
    if model.gff_hints is not None:
        gff_hints = _piece_hints(model.gff_hints.get(rec.name, []), 0,
                                 len(seq) - 1)
    return genetics.encode(seq.lower()), genetics.softmask_runs(seq), \
        gff_hints


def piece_tables(model: Model, rec: FastaRecord, n: Optional[int], device,
                 prefix_sum=None):
    """The first n bases of rec (all of it when n is None) prepared on the
    route that _decode takes for them under `model.route`: (pack_tracks'
    (static, arrays), the piece's GoldEngine, the route: "device_prep",
    arrays as tensors on `device`, or "host_prep", numpy arrays).
    `prefix_sum`: see xputil.use_torch."""
    from .engine.device import build_tracks
    from .engine.device_prep import prepare_on_device
    from .engine.pack import pack_tracks
    codes, softmask, gff_hints = _piece_input(model, rec, n)
    gold = _new_gold(model, False, False)
    if _auto_route(model.route):
        got = prepare_on_device(gold, codes, softmask, gff_hints,
                                resolve_device(device), prefix_sum)
        if got is not None:
            return got[1], gold, "device_prep"
    else:
        gold.collect_hints(codes, softmask, gff_hints)
    gold.prepare_collected()
    return pack_tracks(build_tracks(gold)), gold, "host_prep"


def piece_planes(model: Model, rec: FastaRecord, n: Optional[int], device):
    """The Viterbi kernel's inputs for the first n bases of rec on the host
    route: (static, planes on `device`, the piece's GoldEngine)."""
    from .engine.viterbi import planes_for
    (st, arr), gold, _ = piece_tables(dataclasses.replace(model,
                                                          route="host"),
                                      rec, n, device)
    return st, planes_for(st, arr, device), gold


def piece_scan(model: Model, rec: FastaRecord, n: Optional[int], device):
    """The general Viterbi kernel's inputs (engine/scan.py) for the first n
    bases of rec on the host route: (ScanStatic, tables as tensors on
    `device`, the start column v0 on `device`, the piece's GoldEngine)."""
    from .engine.device import build_tracks
    from .engine.scan import scan_tensors, split_tracks
    codes, softmask, gff_hints = _piece_input(model, rec, n)
    gold = _new_gold(model, False, False)
    gold.collect_hints(codes, softmask, gff_hints)
    gold.prepare_collected()
    tracks = build_tracks(gold)
    st, arrays = split_tracks(tracks)
    dev = resolve_device(device)
    v0 = torch.from_numpy(np.asarray(tracks.log_init, np.float32)).to(dev)
    return st, scan_tensors(arrays, dev), v0, gold


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


def _next_cut_end_point(model, codes, softmask, gff_hints, begin: int,
                        maxstep: int, device, mini_init_synch: bool,
                        mini_term_synch: bool) -> int:
    """reference NAMGene::getNextCutEndPoint (namgene.cc:973)."""
    n = codes.shape[0]
    restlen = n - begin
    if restlen <= maxstep:
        return begin + restlen - 1
    exam = 50000
    if exam < 0.2 * maxstep:
        exam = int(0.2 * maxstep)
    if exam > 150000:
        exam = 150000
    # group gaps between hint groups (reference findGroupGaps)
    gaps = None
    if gff_hints:
        sh = hints_system.SeqHints(list(gff_hints), model.ext_cfg, codes)
        if sh.groups:
            gaps = group_gaps(sh.groups, n)
    if gaps is None:
        gaps = [(1, n - 1)]
    gaps_in_range = [(gs, ge) for (gs, ge) in gaps
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
        stats.count("exams")
        with stats.stage("exam"):
            gold = _new_gold(model, mini_init_synch, mini_term_synch)
            return _decode(gold, codes[s: e + 1], softmask[s: e + 1],
                           _piece_hints(gff_hints, s, e), device,
                           model.route)

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


def cut_pieces(model: Model, codes, softmask, gff_hints, maxstep: int,
               device) -> list:
    """The pieces of a sequence of at most maxstep bases, cut at predicted
    intergenic points (reference NAMGene::doViterbiPiecewise, namgene.cc:
    524): [(begin, end, init_synch, term_synch)].  Each cut-point search
    decodes an exam window, one after another: each depends on the cut
    before it."""
    n = codes.shape[0]
    # the cut-point mini-viterbi inherits the boundary distributions set
    # for the PREVIOUS piece (reference quirk, namgene.cc:576-604)
    prev_init_synch = prev_term_synch = False
    pieces = []
    begin = 0
    while begin < n:
        end = _next_cut_end_point(model, codes, softmask, gff_hints, begin,
                                  maxstep, device, prev_init_synch,
                                  prev_term_synch)
        init_synch = begin > 0
        term_synch = end < n - 1
        if term_synch:
            stats.count("cuts")
        pieces.append((begin, end, init_synch, term_synch))
        prev_init_synch, prev_term_synch = init_synch, term_synch
        begin = end + 1
    return pieces


def piece_inputs(codes, softmask, gff_hints, pieces) -> List[dict]:
    """parallel.mesh.decode_pieces' inputs for the pieces (cut_pieces) of
    a sequence: each piece's codes, softmask, hints and synch flags."""
    return [{"codes": codes[b: e + 1], "softmask": softmask[b: e + 1],
             "gff_hints": _piece_hints(gff_hints, b, e),
             "init_synch": isyn, "term_synch": tsyn}
            for b, e, isyn, tsyn in pieces]


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
    softmask = genetics.softmask_runs(rec.sequence)
    gff_hints = model.gff_hints.get(rec.name, []) \
        if model.gff_hints is not None else None

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
        softmask = softmask[pstart: pend + 1]
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
    pieces = cut_pieces(model, codes, softmask, gff_hints, maxstep, device)

    # the pieces are independent decodes once the cut points are fixed:
    # decode them in flight, one block of a batched launch each
    # (augustus_tpu/predict.py:625-645, its mesh's "data" axis; one card's
    # SMs here), unless sampling needs each piece's forward table
    precomputed = [None] * len(pieces)
    if (len(pieces) > 1 and props.get_bool("pieceParallel", True)
            and not props.get_bool("mea", False)
            and props.get_int("sample", 0) <= 1):
        from .parallel.mesh import decode_pieces
        precomputed = decode_pieces(
            model, piece_inputs(codes, softmask, gff_hints, pieces), device)

    for (begin, end, init_synch, term_synch), pre in zip(pieces,
                                                         precomputed):
        agl, with_evidence = _find_genes(
            model, codes[begin: end + 1], softmask[begin: end + 1],
            _piece_hints(gff_hints, begin, end), device, init_synch,
            term_synch, pre)
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
                bodies.append(og.print_gene_list(
                    agl, codes, o, model.gcode, with_evidence=with_evidence,
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
    # the record's outputs are on the host: its stages' events have ended
    stats.flush()
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


def anno_to_gene(tg, seqname: str) -> og.Gene:
    """A GenBank TGene annotation as an output Gene with typed exon states
    (augustus_tpu/predict.py:463-506, reference GBProcessor::getAnnoSequence
    type assignment, src/genbank.cc:137-156)."""
    g = og.Gene()
    g.geneid = tg.geneid
    g.id = tg.id
    g.seqname = seqname
    g.strand = tg.strand
    g.codingstart = tg.codingstart
    g.codingend = tg.codingend
    g.transstart = tg.transstart
    g.transend = tg.transend
    g.complete5utr = tg.complete_l if tg.strand == "+" else tg.complete_r
    g.complete3utr = tg.complete_r if tg.strand == "+" else tg.complete_l
    plus = tg.strand == "+"
    clength = 0
    nex = len(tg.exons)
    for i, (b, e) in enumerate(tg.exons):
        clength += e - b + 1
        if i == 0:
            if nex == 1:
                t = ST.singleG if plus else ST.rsingleG
            else:
                t = (initial_exon_type(clength) if plus
                     else r_terminal_exon_type(2 - clength))
        elif i == nex - 1:
            t = ST.terminal if plus else ST.rinitial
        else:
            t = (internal_exon_type(clength) if plus
                 else r_internal_exon_type(2 - clength))
        g.exons.append(og.PathState(b, e, t))
    for (b, e) in tg.introns:
        g.introns.append(og.PathState(b, e, ST.intron_type))
    for (b, e) in tg.utr5exons:
        g.utr5exons.append(og.PathState(
            b, e, ST.utr5internal if plus else ST.rutr5internal))
    for (b, e) in tg.utr3exons:
        g.utr3exons.append(og.PathState(
            b, e, ST.utr3internal if plus else ST.rutr3internal))
    return g


def evaluate_genbank(model: Model, path: str, device=None) -> str:
    """Predict on every record of a GenBank-annotated test set, each a
    sequence of its own, and print the annotation, the prediction and the
    accuracy tables (augustus_tpu/predict.py:509-554, reference
    evaluateOnTestSet, src/augustus.cc:254)."""
    from .io.genbank import read_genbank
    from .output.evaluation import Evaluation
    device = resolve_device(device)
    props = model.props
    with_utr = props.get("UTR", "off") in ("both", "1", "on", "5", "true")
    annoseqs = read_genbank(path, with_utr=with_utr,
                            stop_excluded=props.get_bool(
                                "stopCodonExcludedFromCDS", False))
    out: List[str] = ["# Read in %d genbank sequences." % len(annoseqs)]
    evaluation = Evaluation()
    anno_opts = og.OutputOptions.from_properties(props)
    gid = 1
    strand = _strand_option(props)
    strand_text = {"+": "forward strand", "-": "reverse strand",
                   "both": "both strands"}[strand]
    for num, a in enumerate(annoseqs, start=1):
        out += ["#", "# ----- sequence number %d (length = %d, name = %s)"
                " -----" % (num, a.length, a.seqname), "#", "",
                "# annotation: ",
                "# Sequence %s length=%d" % (a.seqname, a.length)]
        anno_genes = [anno_to_gene(tg, a.seqname) for tg in a.genes]
        for ag in anno_genes:
            og.print_gene_gff(ag, anno_opts, out, source="database")
        out.append("# Predicted genes for sequence number %d on %s"
                   % (num, strand_text))
        text, ngenes, transcripts = predict_sequence(
            model, FastaRecord(name=a.seqname, sequence=a.sequence),
            seq_number=num, geneid_start=gid, device=device,
            with_header=False)
        gid += ngenes
        if text:
            out.append(text.rstrip("\n"))
        evaluation.add_to_evaluation(transcripts, anno_genes, strand=strand,
                                     quotient=0.0)
    evaluation.finish(out)
    evaluation.print_quotients(out)
    evaluation.print_tables(out)
    return "\n".join(out) + "\n"
