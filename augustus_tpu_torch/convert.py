"""Carry a model's parameters and a chunk's packed or split tracks across
packages.

The inputs are plain data: dicts of numpy arrays, lists and scalars as
`dataclasses.asdict` gives them for the reference package's objects, with
state types as ints.  Nothing here imports the reference package, so the
tests can show that both packages decode the same thing from the same
parameters, independently of file parsing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import genetics
from .constants import Constants
from .model import gc as gcmod
from .model import pbl
from .model.state_config import ST, StateGraph
from .properties import Properties
from .engine import pack as P
from .engine import scan as SC


def _motif(d: dict) -> pbl.Motif:
    return pbl.Motif(n=int(d["n"]), k=int(d["k"]),
                     window_probs=np.asarray(d["window_probs"]))


def _binned(d: dict) -> pbl.BinnedProbs:
    return pbl.BinnedProbs(nbins=int(d["nbins"]),
                           boundaries=np.asarray(d["boundaries"]),
                           avprobs=np.asarray(d["avprobs"]))


def model_from_reference(fields: Dict[str, dict]):
    """The port's Model from the fields of a reference Model.

    fields: {"props": {"config_path", "store"}, "cn": {...},
    "sg": {..., "state_types": [int]}, "igp", "exp", "inp", "decomp":
    asdict-style dicts, "gcode": {"table": int}, and for UTR
    architectures "utr" and "utr_cfg" (asdict of UtrParams, UtrConfig)}."""
    from .predict import Model
    p = fields["props"]
    props = Properties(config_path=p["config_path"], store=dict(p["store"]))
    cn = Constants(**fields["cn"])
    s = fields["sg"]
    sg = StateGraph(statecount=int(s["statecount"]),
                    model_class=list(s["model_class"]),
                    state_types=[ST(int(t)) for t in s["state_types"]],
                    init_probs=np.asarray(s["init_probs"]),
                    term_probs=np.asarray(s["term_probs"]),
                    transitions=np.asarray(s["transitions"]),
                    synch_state=int(s["synch_state"]))
    i = fields["igp"]
    igp = pbl.IgenicParams(k=int(i["k"]), gc=[
        pbl.IgenicGCParams(pls=[np.asarray(x) for x in g["pls"]],
                           emiprobs=np.asarray(g["emiprobs"]))
        for g in i["gc"]])
    e = fields["exp"]
    exp = pbl.ExonParams(
        k=int(e["k"]), exon_len_d=int(e["exon_len_d"]), num=dict(e["num"]),
        num_huge=dict(e["num_huge"]),
        len_dist={k: np.asarray(v) for k, v in e["len_dist"].items()},
        gc=[pbl.ExonGCParams(
            pls=[np.asarray(x) for x in g["pls"]],
            emiprobs=np.asarray(g["emiprobs"]),
            initemiprobs=np.asarray(g["initemiprobs"]),
            etemiprobs=np.asarray(g["etemiprobs"]),
            trans_init_motif=_motif(g["trans_init_motif"]),
            et_motif=[_motif(m) for m in g["et_motif"]],
            tis_bin=_binned(g["tis_bin"])) for g in e["gc"]],
        start_codon_probs=(dict(e["start_codon_probs"])
                           if e["start_codon_probs"] is not None else None))
    n = fields["inp"]
    inp = pbl.IntronParams(
        k=int(n["k"]), d=int(n["d"]), ass_probs=np.asarray(n["ass_probs"]),
        dss_probs=np.asarray(n["dss_probs"]), ass_bin=_binned(n["ass_bin"]),
        dss_bin=_binned(n["dss_bin"]), len_dist=np.asarray(n["len_dist"]),
        c_ass=int(n["c_ass"]), c_dss=int(n["c_dss"]),
        ass_pseudo=float(n["ass_pseudo"]), dss_pseudo=float(n["dss_pseudo"]),
        non_ag_ass_prob=float(n["non_ag_ass_prob"]),
        non_gt_dss_prob=float(n["non_gt_dss_prob"]),
        gc=[pbl.IntronGCParams(prob_short_intron=float(g["prob_short_intron"]),
                               mal=float(g["mal"]),
                               emiprobs=np.asarray(g["emiprobs"]),
                               ass_motif=_motif(g["ass_motif"]))
            for g in n["gc"]])
    d = fields["decomp"]
    decomp = gcmod.Decomposition(
        comps=np.asarray(d["comps"]), weighing_type=int(d["weighing_type"]),
        weight_matrix=(np.asarray(d["weight_matrix"])
                       if d["weight_matrix"] is not None else None))
    utr = utr_cfg = None
    if fields.get("utr") is not None:
        from .engine.gold_utr import UtrConfig
        u = fields["utr"]
        utr = pbl.UtrParams(
            k=int(u["k"]), tssup_k=int(u["tssup_k"]),
            exon_len_d=int(u["exon_len_d"]),
            aataaa_probs=np.asarray(u["aataaa_probs"]),
            aataaa_boxlen=int(u["aataaa_boxlen"]),
            len_dist={k: np.asarray(v) for k, v in u["len_dist"].items()},
            tail_len_dist5=np.asarray(u["tail_len_dist5"]),
            tail_len_dist3=np.asarray(u["tail_len_dist3"]),
            gc=[pbl.UtrGCParams(
                emi_5init=np.asarray(g["emi_5init"]),
                emi_5=np.asarray(g["emi_5"]), emi_3=np.asarray(g["emi_3"]),
                tssup=np.asarray(g["tssup"]),
                tss_motif=_motif(g["tss_motif"]),
                tss_motif_tata=_motif(g["tss_motif_tata"]),
                tata_motif=_motif(g["tata_motif"]),
                tts_motif=_motif(g["tts_motif"])) for g in u["gc"]])
        utr_cfg = UtrConfig(**fields["utr_cfg"])
    return Model(props=props, cn=cn, sg=sg, igp=igp, exp=exp, inp=inp,
                 decomp=decomp,
                 gcode=genetics.GeneticCode(int(fields["gcode"]["table"])),
                 utr=utr, utr_cfg=utr_cfg)


def pack_from_reference(static_fields: dict, arrays: Dict[str, np.ndarray]):
    """(PKStatic, arrays) of the port from the asdict of a reference
    PKStatic and its pack_tracks arrays.  With sparse hints (NHW > 0) the
    hint records, NHW and hint_lm come across as they are, and the
    reference's 128-lane xh/xi maps are cut to the lanes in use."""
    f = dict(static_fields)
    convs = []
    for c in f["convs"]:
        c = dict(c)
        h = c.pop("hint", None)
        if h is not None:
            c["hint"] = P.PKHint(**{**h, "cross": tuple(map(tuple, h[
                "cross"])), "ex": tuple(map(tuple, h["ex"]))})
        c["variants"] = tuple(P.PKVariant(**v) for v in c["variants"])
        convs.append(P.PKConv(**c))
    st = P.PKStatic(
        **{**f,
           "chain_states": tuple(f["chain_states"]),
           "fixed_groups": tuple(P.PKFixedGroup(**{**g, "states": tuple(
               g["states"])}) for g in f["fixed_groups"]),
           "lessd": tuple(P.PKLessD(**d) for d in f["lessd"]),
           "pinned": tuple(P.PKPinned(**p) for p in f["pinned"]),
           "hint_lm": (tuple(f["hint_lm"]) if f["hint_lm"] is not None
                       else None),
           "convs": tuple(convs)})
    out = {k: np.asarray(arrays[k])
           for k in P.PLANE_INPUTS + P.KERNEL_CONSTANTS + ("log_term",)}
    if st.NHW:
        for k in ("m_xh", "m_xi"):
            m = np.asarray(arrays[k])
            out[k] = m[m >= 0]
        out["hw_src"] = np.asarray(arrays["hw_src"])
    return st, out


def scan_from_reference(static_fields: dict, arrays: Dict[str, object]):
    """(ScanStatic, arrays) of the port from the asdict of a reference
    ScanStatic and its split_tracks arrays (numpy arrays as they are;
    scalars such as n_true as numpy scalars)."""
    f = dict(static_fields)

    def hint(h):
        if h is None:
            return None
        return SC.HintConvStatic(**{
            **h, "cross_cols": tuple(map(tuple, h["cross_cols"])),
            "ex_cols": tuple(map(tuple, h["ex_cols"]))})

    convs = tuple(SC.ConvStatic(**{
        **c, "hint": hint(c["hint"]),
        "variants": tuple(SC.VariantStatic(**{
            **v, "fsel": (tuple(v["fsel"]) if v["fsel"] is not None
                          else None)}) for v in c["variants"])})
        for c in f["convs"])
    st = SC.ScanStatic(**{
        **f,
        "chain": tuple(SC.ChainStatic(**c) for c in f["chain"]),
        "fixed": tuple(SC.FixedStatic(**x) for x in f["fixed"]),
        "lessd": tuple(SC.LessDStatic(**x) for x in f["lessd"]),
        "pinned": tuple(SC.PinnedStatic(**x) for x in f["pinned"]),
        "convs": convs,
        "hint_lm": (tuple(f["hint_lm"]) if f["hint_lm"] is not None
                    else None)})
    return st, {k: np.asarray(v) for k, v in arrays.items()}
