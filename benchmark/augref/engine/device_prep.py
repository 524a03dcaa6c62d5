"""The device route: track preparation, Viterbi kernel and traceback on
the card for one chunk.

Counterpart of `augustus_tpu/engine/pallas_prep.py:try_device_decode`.
Host work per chunk is the hint collection (SeqHints), the sparse overlays
(`jgold.build_overlays`, O(#hints)) and the GC-class stairs; the code
array, the stairs and the overlays go to the card, where JGold,
`build_tracks`, `split_tracks` and `pack_tracks` build every table as
torch tensors (float64, the ordered prefix-sum kernel csrc/prefix.cu for
the cumulative tracks), the Viterbi kernel runs, and the event walk
(csrc/trace.cu) walks the path where the plane lies; only the events come
back.  Stages: `prep` (host), `dev_prep` (CUDA events on the card),
`expand` and `kernel`, `traceback`.

The route is decided before any work on the device, the same way on
`cuda` and on `cpu` (where the tensors lie on the CPU and every kernel
runs its plain version): every state's model class is igenicmodel,
intronmodel or exonmodel, and the chunk has no exon/CDS-kind hint.  The
reference's other two limits are properties of the TPU's kernel blocks
and jit cache and do not apply: the port's kernel reads each position's
GC class (no limit on class switches) and torch runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import gc as gcmod
from . import xputil as U
from .gold import GoldEngine
from .jgold import JGold, build_overlays

DEVICE_MODEL_CLASSES = ("igenicmodel", "intronmodel", "exonmodel")


def prepare_on_device(gold: GoldEngine, codes: np.ndarray, softmask,
                      gff_hints, device, prefix_sum=None):
    """The device route's tables of one chunk: (tracks, pack_tracks'
    (static, arrays) with the arrays on `device`), or None when the chunk
    lies outside the route (then nothing ran on the device).  `prefix_sum`:
    see xputil.use_torch.

    Side effect on `gold` in both cases: `collect_hints` sets .codes, .n,
    .has_hints and .hints (host SeqHints), which the host route continues
    from (`gold.prepare_collected()`) and the evidence output reads."""
    from .. import stats
    from .device import build_tracks
    from .pack import pack_tracks
    device = torch.device(device)
    with stats.stage("prep"):
        gold.collect_hints(codes, softmask, gff_hints)
        if any(mc not in DEVICE_MODEL_CLASSES for mc in gold.sg.model_class):
            return None
        meta, ov = build_overlays(gold.hints, gold.n, np.float64)
        if meta.sparse_exon:
            return None
        stairs = gcmod.compute_stairs(codes, gold.cn, gold.decomp)

    with stats.stage("dev_prep", device):
        jg = JGold(gold.sg, gold.cn, gold.igp, gold.exp, gold.inp,
                   gold.decomp, gold.gcode, ext_cfg=gold.ext_cfg)
        jg.log_init = gold.log_init.copy()
        jg.log_term = gold.log_term.copy()
        with U.use_torch(device, prefix_sum):
            codes_d = torch.from_numpy(np.ascontiguousarray(codes)).to(
                device).long()
            stairs_d = torch.from_numpy(stairs).to(device)
            jg.device_prepare(codes_d, stairs_d, meta, ov)
            tracks = build_tracks(jg)
            return tracks, pack_tracks(tracks)


def device_engine(gold: GoldEngine, codes: np.ndarray, softmask, gff_hints,
                  device):
    """The device route's ViterbiEngine of one chunk, its tables on
    `device` and not yet run, or None when the chunk lies outside the route
    or K1 cannot hold it (viterbi.k1_fits, asked before any launch; see
    prepare_on_device for the side effects on `gold`).  A caller that
    decodes many chunks prepares them all first and launches later
    (parallel/mesh.py)."""
    from .. import stats
    from .viterbi import ViterbiEngine, k1_fits
    got = prepare_on_device(gold, codes, softmask, gff_hints, device)
    if got is None:
        return None
    tracks, packed = got
    if not k1_fits(*packed):
        # K1 cannot hold the chunk (viterbi.k1_refusal): the host route
        # takes it, with K2 (predict._engine)
        stats.count("k1_capacity_to_host")
        return None
    return ViterbiEngine(tracks, device, packed)


def try_device_decode(gold: GoldEngine, codes: np.ndarray, softmask,
                      gff_hints, device):
    """Decode one chunk on the device route: the condensed PathState list,
    or None when the chunk lies outside the route (see prepare_on_device
    for the side effects on `gold`)."""
    from .. import stats
    eng = device_engine(gold, codes, softmask, gff_hints, device)
    if eng is None:
        return None
    eng.run()
    with stats.stage("traceback", eng.device):
        return eng.traceback_path(gold.n)
