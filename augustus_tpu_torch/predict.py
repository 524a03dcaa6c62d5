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
  host traceback.

`stats` counts the route of every piece.  Softmasked or hinted runs print
the evidence block of every transcript.  Pieces decode in order.

With --sample=N (N >= 10) a piece takes the host route, as augustus_tpu
routes it, and also fills the forward table on `device`
(engine/forward.py); the findGenes step then draws N - 1 paths from it on
the host (GoldEngine.sample_path, the glibc rand() stream of crand.py kept
on the Model), merges identical transcripts and gives every transcript and
state its posterior probability, which --alternatives-from-sampling,
--keep_viterbi, --minexonintronprob and --minmeanexonintronprob use as in
the reference; --temperature=t heats the forward table and the walk.

Outside the port so far, and raising NotImplementedError: UTR and ncRNA
architectures, MEA (--mea), alternative transcripts from evidence
(--alternatives-from-evidence) and GenBank evaluation.
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
from .properties import Properties, init_properties, parse_bool
from .model.state_config import parse_state_config, StateGraph, ST
from .model import pbl, gc as gcmod
from .engine.gold import GoldEngine
from .hints import config as hints_config
from .hints import system as hints_system
from .hints.features import group_gaps
from .io.fasta import FastaRecord, read_fasta
from .output import evidence as ev
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
        for key in ("UTR", "nc"):
            if parse_bool(str(args.get(key, "off"))):
                raise NotImplementedError(
                    "not ported yet: UTR / ncRNA models (--UTR=off)")
        props = init_properties(args, config_path)
        cn = Constants.from_properties(props)
        _check_scope(props)
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
                   ext_cfg=ext_cfg, gff_hints=gff_hints)


def _check_scope(props: Properties) -> None:
    """Raise for every request the port does not cover yet."""
    missing = []
    if props.get_bool("UTR", False) or props.get_bool("nc", False):
        missing.append("UTR / ncRNA models (--UTR=off)")
    if props.get_bool("mea", False):
        missing.append("MEA (--mea, augustus_tpu/output/mea.py)")
    if props.get_bool("alternatives-from-evidence", False):
        missing.append("alternative transcripts from evidence "
                       "(--alternatives-from-evidence, "
                       "augustus_tpu/hints/alternatives.py)")
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


def _decode(gold: GoldEngine, codes, softmask, gff_hints,
            device: torch.device, route: str = "auto",
            need_forward: bool = False):
    """One Viterbi decode on the piece's route (augustus_tpu/predict.py:
    113-157; route "host" forces the host route); returns the condensed
    PathState list.  need_forward (sampling): the host route, and gold.f
    filled with the forward table of the same packing."""
    from .engine.device import build_tracks
    from .engine.device_prep import try_device_decode
    from .engine.forward import ForwardEngine
    from .engine.viterbi import ViterbiEngine
    if _auto_route(route) and not need_forward:
        path = try_device_decode(gold, codes, softmask, gff_hints, device)
        if path is not None:
            stats.count("device_prep")
            return path
    else:
        with stats.stage("prep"):
            gold.collect_hints(codes, softmask, gff_hints)
    stats.count("host_prep")
    with stats.stage("prep"):
        gold.prepare_collected()
    with stats.stage("build_tracks"):
        tracks = build_tracks(gold)
    with stats.stage("pack"):
        eng = ViterbiEngine(tracks, device)
        fwd = ForwardEngine(tracks, device, (eng.static, eng.arrays)) \
            if need_forward else None
    eng.run()
    if fwd is not None:
        gold.f = fwd.run()
        gold._classify_states()
    with stats.stage("traceback"):
        return eng.traceback_path(codes.shape[0])


def _auto_route(route: str) -> bool:
    """Model.route: True for "auto", False for "host"."""
    if route not in ("auto", "host"):
        raise ValueError(f"route {route!r}: 'auto' or 'host'")
    return route == "auto"


def _new_gold(model: Model, init_synch: bool, term_synch: bool) -> GoldEngine:
    gold = GoldEngine(model.sg, model.cn, model.igp, model.exp, model.inp,
                      model.decomp, model.gcode, ext_cfg=model.ext_cfg)
    gold.set_boundaries(init_synch, term_synch)
    return gold


def _sampling(props: Properties):
    """(sample iterations, alternatives from sampling): the reference's
    sampling configuration (namgene.cc:54-92,768), as
    augustus_tpu/predict.py:200-218 reads it (--mea is refused by
    _check_scope)."""
    sample_iters = props.get_int("sample", 0)
    if 0 < sample_iters < 10:
        sample_iters = 0       # reference refuses too-low sample counts
    return max(sample_iters, 1), props.get_bool("alternatives-from-sampling",
                                                False)


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
                term_synch: bool = False):
    """Viterbi decode, sampling when asked, gene projection and filtering
    on one sequence piece (reference NAMGene::findGenes, namgene.cc:763);
    returns (agl, with_evidence) in piece-local coordinates."""
    cn = model.cn
    props = model.props
    sample_iters, alt_sampling = _sampling(props)
    need_forward = sample_iters > 1
    gold = _new_gold(model, init_synch, term_synch)
    path = _decode(gold, codes, softmask, gff_hints, device, model.route,
                   need_forward)
    with stats.stage("project"):
        genes = og.project_onto_genes(path, cn)
        _mark(genes, viterbi=True, throwaway=False)
    if need_forward:
        genes = _sample_transcripts(model, gold, genes, codes.shape[0],
                                    sample_iters, alt_sampling)
    with stats.stage("project"):
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
        gold = _new_gold(model, mini_init_synch, mini_term_synch)
        return _decode(gold, codes[s: e + 1], softmask[s: e + 1],
                       _piece_hints(gff_hints, s, e), device, model.route)

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
        pieces.append((begin, end, init_synch, term_synch))
        prev_init_synch, prev_term_synch = init_synch, term_synch
        begin = end + 1

    for (begin, end, init_synch, term_synch) in pieces:
        agl, with_evidence = _find_genes(
            model, codes[begin: end + 1], softmask[begin: end + 1],
            _piece_hints(gff_hints, begin, end), device, init_synch,
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
