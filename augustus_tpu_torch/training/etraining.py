"""etraining driver: GenBank training set -> species .pbl parameter files.

Reference flow (src/etraining.cc main): read the annotated sequences, split
into single-gene forward-strand pieces, loop over GC-content classes
weighting genes by base composition, run each model's buildModel, then write
the parameter files.

Port of `augustus_tpu/training/etraining.py`.  The counting and the files
are host numpy; with --CRF=on every training gene is predicted on the
device the caller gives (`cuda` unless asked otherwise, no fallback), each
prediction through the port's kernels (training/crf.py).  With stats on,
the stage `train` times the host counting and writing and `crf` the CRF
rounds, whose predictions add their own stages (`dev_prep`, `kernel`,
`traceback`).
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .. import stats
from ..constants import Constants
from ..properties import init_properties
from ..model import gc as gcmod
from ..io.genbank import detect_format, read_genbank
from .annotation import split_to_single_gene_seqs
from .models import ExonTrainer, IGenicTrainer, IntronTrainer
from . import pbl_write


def _basecount_weight(decomp: gcmod.Decomposition, target: np.ndarray,
                      freqs) -> int:
    """BaseCount::weight (src/motif.cc:101): int cast of doubleWeight."""
    if decomp.weighing_type == 3 and decomp.weight_matrix is not None:
        z = np.asarray(freqs, dtype=np.float64) - target
        t = float(z @ decomp.weight_matrix @ z)
        return int(1 + 9 * math.exp(-t))
    if decomp.weighing_type == 2:
        gc1 = target[1] + target[2]
        gc2 = freqs[1] + freqs[2]
        return 1 if _gc_class(gc1) == _gc_class(gc2) else 0
    return 1


def _gc_class(gc: float) -> int:
    if gc < .43:
        return 0
    if gc < .51:
        return 1
    if gc < .57:
        return 2
    return 3


def run_training(args: Dict[str, str], config_path: Optional[str] = None,
                 device=None) -> None:
    """Train the species of args["species"] on args["queryfile"]; the CRF
    rounds (--CRF=on) predict on `device` (predict.resolve_device: `cuda`
    unless asked otherwise; raises without a card)."""
    from ..predict import resolve_device
    device = resolve_device(device)
    with stats.stage("train"):
        trainers, singles, props, bcs = _train_ml(args, config_path)
    if props.get_bool("CRF", False) and "exonmodel" in trainers:
        with stats.stage("crf"):
            _train_crf(trainers, singles, props, bcs, device)


def _train_ml(args, config_path):
    """The maximum-likelihood counts and the parameter files: (trainers by
    state name, single-gene sequences, properties, base compositions)."""
    props = init_properties(args, config_path)
    cn = Constants.from_properties(props)
    # training default: GC donor consensus allowed (etraining.cc:75 sets
    # dss_gc_allowed = true before Constant::init)
    cn.dss_gc_allowed = props.get_bool("/IntronModel/allow_dss_consensus_gc",
                                       True)
    queryfile = props.get("queryfile")
    if detect_format(queryfile) != "genbank":
        raise ValueError("Input file not in genbank format.")
    utr_str = props.get("UTR", "off")
    with_utr = utr_str in ("both", "1", "on", "5", "true")
    stop_excluded = props.get_bool("stopCodonExcludedFromCDS", False)
    annoseqs = read_genbank(queryfile, with_utr=with_utr,
                            stop_excluded=stop_excluded)
    print("# Read in %d genbank sequences." % len(annoseqs))
    singles = split_to_single_gene_seqs(annoseqs)
    if not singles:
        raise ValueError("Could not properly read Annotation.")

    decomp = gcmod.make_decomposition(cn, props)

    # training state list (/EHMMTraining/state00..) sets the model order
    statecount = props.get_int("/EHMMTraining/statecount", 3)
    trainers = {}
    order: List[str] = []
    for i in range(statecount):
        name = props.get("/EHMMTraining/state%02d" % i)
        order.append(name)
        if name == "exonmodel":
            trainers[name] = ExonTrainer(props, cn)
        elif name == "intronmodel":
            trainers[name] = IntronTrainer(props, cn)
        elif name == "igenicmodel":
            trainers[name] = IGenicTrainer(props, cn)
        elif name == "utrmodel":
            from .utr import UtrTrainer
            trainers[name] = UtrTrainer(props, cn)
        else:
            trainers[name] = None

    n_classes = decomp.n_classes
    for idx in range(n_classes):
        target = decomp.comps[idx]
        for a in singles:
            if n_classes > 1:
                w = _basecount_weight(decomp, target,
                                      np.asarray(a.base_freqs()))
            else:
                w = 1
            a.weight = w
            for g in a.genes:
                g.weight = w
        for name in order:
            t = trainers.get(name)
            if t is None:
                continue
            t.build(singles)
            if name == "utrmodel":
                # storeGCPars mixes with the intron chain (utrtrain.cc:860)
                t.store_gc(idx, trainers.get("intronmodel"))
            else:
                t.store_gc(idx)

    # write parameter files
    bcs = [decomp.comps[i] for i in range(n_classes)]
    sp_dir = props.species_dir()
    ex = trainers.get("exonmodel")
    intr = trainers.get("intronmodel")
    ig = trainers.get("igenicmodel")
    if ex is not None:
        path = os.path.join(sp_dir, props.get("/ExonModel/outfile"))
        print("Writing exon model parameters [1] to file %s." % path)
        pbl_write.write_exon_pbl(ex, bcs, path)
    if intr is not None:
        path = os.path.join(sp_dir, props.get("/IntronModel/outfile"))
        print("Writing intron model parameters [1] to file %s." % path)
        pbl_write.write_intron_pbl(intr, bcs, path)
    if ig is not None:
        path = os.path.join(sp_dir, props.get("/IGenicModel/outfile"))
        print("Writing intergenic region model parameters [1] to file %s."
              % path)
        tie = props.get_bool("tieIgenicIntron", True)
        pbl_write.write_igenic_pbl(ig, bcs, path, intron=intr,
                                   tie_igenic_intron=tie)
    ut = trainers.get("utrmodel")
    if ut is not None:
        path = os.path.join(sp_dir, props.get("/UtrModel/outfile"))
        print("Writing UTR model parameters [1] to file %s." % path)
        pbl_write.write_utr_pbl(ut, bcs, path)

    return {k: v for k, v in trainers.items() if v is not None}, singles, \
        props, bcs


def _train_crf(trainers, singles, props, bcs, device) -> None:
    """The optional CRF (discriminative) phase: reference etraining.cc:218
    CRFbuildParameters -> CRF::train; the ML-trained parameter files are
    kept as .HMM copies (etraining.cc:138-141) and the emission sections
    are re-written with the discriminatively updated probabilities."""
    import shutil
    from ..predict import Model
    from .crf import CRFTrainer
    ex = trainers["exonmodel"]
    intr = trainers.get("intronmodel")
    sp_dir = props.species_dir()
    n_classes = len(bcs)
    rounds = props.get_int("CRF_N", 2)
    print("use OLM algorithm (Online Large Margin) for training")
    model = Model.load({
        "species": props.get("species"),
        "AUGUSTUS_CONFIG_PATH": props.get("AUGUSTUS_CONFIG_PATH",
                                          props.config_path),
        "UTR": "off", "softmasking": "0"})
    crf = CRFTrainer(model, rounds=rounds, device=device)
    crf.train(singles)
    for name, outkey in (("exonmodel", "/ExonModel/outfile"),
                         ("intronmodel", "/IntronModel/outfile")):
        p = os.path.join(sp_dir, props.get(outkey))
        shutil.copyfile(p, p + ".HMM")
    for idx in range(n_classes):
        for f in range(3):
            ex.gc_emiprobs[idx][f] = \
                np.asarray(model.exp.gc[idx].emiprobs[f])
        if intr is not None:
            intr.gc_emiprobs[idx] = \
                np.asarray(model.inp.gc[idx].emiprobs)
    path = os.path.join(sp_dir, props.get("/ExonModel/outfile"))
    print("Writing exon model parameters [1] to file %s." % path)
    pbl_write.write_exon_pbl(ex, bcs, path)
    if intr is not None:
        path = os.path.join(sp_dir, props.get("/IntronModel/outfile"))
        print("Writing intron model parameters [1] to file %s." % path)
        pbl_write.write_intron_pbl(intr, bcs, path)


def main(argv: List[str] = None) -> int:
    """etraining's command line; --device=cpu|cuda (default cuda) is where
    the CRF rounds predict.  Without a card the device check raises before
    anything is read or written."""
    from ..predict import resolve_device
    argv = argv if argv is not None else sys.argv[1:]
    args: Dict[str, str] = {}
    for a in argv:
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
                args[k] = v
            else:
                args[a[2:]] = "true"
        else:
            args["queryfile"] = a
    device = resolve_device(args.pop("device", "cuda"))
    try:
        run_training(args, device=device)
    except Exception as e:
        print("etraining: ERROR\n\t%s" % e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
