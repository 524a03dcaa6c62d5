"""Pieces in flight: the pieces of a sequence decoded as batches on one card.

Port of `augustus_tpu/parallel/mesh.py`.  There the pieces of a long
sequence are stacked, sharded over a device mesh axis ("data") with
`shard_map`, and each device runs its chunks' scans and walks
(`make_batched_fn`: `vmap` of the scan and of `make_trace_body`); only the
emits come back.  On one H100 the counterpart of the "data" axis is the
card's SMs:

* each piece's Viterbi pass is one block of one batched launch of its
  kernel (`viterbi.viterbi_forward_batch`: K1, hinted pieces with K1.f in a
  launch of their own; `scan.scan_forward_batch`: K2), where the
  sequential path launches one block per piece, one piece after another;
* the walk start, the argmax of v_final + log_term, is taken on the card;
* one batched launch of the event walk K4 (`traceback.event_walk_batch`)
  walks every piece's plane where it lies, whatever its width; only the
  events come back.

Each piece takes the route and kernel that `predict._decode` would give it
(`predict._engine`): the device route with K1, or the host route with K1
or K1.f, or with K2 where `scan.needs_general_scan`.  The port has no gold
engine on its path: a piece that no kernel takes raises, as on the
sequential path, where augustus_tpu falls back to `gold.run`.  The pieces
are prepared in order and cut into batches whose resident bytes (tables,
planes, lane history, backpointer plane, the walk's breaks and events)
stay within MEMORY_SHARE of the device's free memory when the call starts;
`decode_pieces.last` records the batches, the blocks of each launch, the
bytes per base of each kernel's pieces, the budget and the bytes that the
caching allocator held free when the budget was read.

On the CPU the same function runs the plain versions, piece after piece.
There is no `make_batched_fn` or `stack_arrays`: the pieces are not padded
to one length or stacked, since each block reads its own piece's record.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List

import numpy as np
import torch

from .. import stats
from ..engine.traceback import (M_EVENTS, condensed_path_events,
                                event_walk_batch)

# the share of the device's free memory (the host's available memory on
# the CPU) that one batch's resident tensors may take
MEMORY_SHARE = 0.5


def memory_budget(device: torch.device) -> int:
    """Bytes one batch may keep resident on `device`."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(free * MEMORY_SHARE)


def cached_free_bytes(device: torch.device) -> int:
    """Bytes that the caching allocator holds free on `device` (reserved
    and not allocated), which `memory_budget`'s free memory does not count;
    0 on the CPU."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)


def _kernel(eng) -> str:
    """The kernel row that decodes the engine's piece."""
    from ..engine.scan import ScanEngine
    if isinstance(eng, ScanEngine):
        return "scan_forward"
    return "viterbi_forward:hint_quot" if eng.static.NHW else \
        "viterbi_forward"


def _resident_bytes(eng, inputs) -> int:
    """The bytes that a piece keeps on its device from its preparation to
    the end of its walk: the engine's tables, the kernel's inputs, its
    outputs and scratch (K1: the (64, W_PAD + n) lane history; K2: the
    lanes and their args), the backpointer plane and the walk's breaks
    and events buffer."""
    from ..engine.pack import W_PAD
    from ..engine.scan import END_PAD
    tensors = [v for v in eng.arrays.values() if isinstance(v, torch.Tensor)]
    if isinstance(inputs, tuple):                        # K2: (tables, v0)
        tensors += list(inputs[0].values()) + [inputs[1]]
    else:
        tensors += [v for v in inputs.values() if isinstance(v, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = eng.n
    if _kernel(eng) == "scan_forward":
        W = eng.S
        nbytes += eng.static.NL * (n + eng.static.PAD + END_PAD) * 5
    else:
        W = 64
        nbytes += 2 * 64 * (W_PAD + n) * 4
    return nbytes + 2 * n * W * 4 + M_EVENTS * 5 * 4


def _start_states(engines, outs):
    """The walk start of every piece, on the card: the first argmax of
    v_final + log_term over the model's states (the engines' _walk_start,
    without the copy to the host), and the value there."""
    from ..engine.viterbi import NEG
    starts, bests = [], []
    for eng, (_, vfin, _) in zip(engines, outs):
        dev = vfin.device
        vf = torch.full((eng.tracks.S,), float(NEG), dtype=torch.float32,
                        device=dev)
        vf[: eng.S] = vfin[: eng.S]
        last = vf + torch.from_numpy(np.asarray(eng.tracks.log_term)).to(dev)
        state = torch.argmax(last)
        starts.append(state)
        bests.append(last[state].to(torch.float64))
    return starts, bests


def _decode_batch(batch, device, out, record) -> None:
    """Launch, walk and condense one batch of prepared pieces:
    batch = [(index, gold, engine, inputs, dnalen)]; out[index] = (path,
    gold)."""
    from ..engine.scan import scan_forward_batch
    from ..engine.viterbi import NEG, viterbi_forward_batch
    groups: Dict[str, List[int]] = {}
    for k, (_, _, eng, _, _) in enumerate(batch):
        groups.setdefault(_kernel(eng), []).append(k)
    outs = [None] * len(batch)
    # on the card, the launches of several kernels run side by side, each
    # on a stream of its own
    main = torch.cuda.current_stream(device) \
        if device.type == "cuda" and len(groups) > 1 else None
    with stats.stage("kernel", device):
        for kernel, ks in groups.items():
            items = [(batch[k][2].static, batch[k][3]) for k in ks]
            side = None
            if main is not None:
                side = torch.cuda.Stream(device)
                side.wait_stream(main)
            with torch.cuda.stream(side) if side is not None \
                    else contextlib.nullcontext():
                if kernel == "scan_forward":
                    got = scan_forward_batch([(st, t, v0)
                                              for st, (t, v0) in items])
                else:
                    got = viterbi_forward_batch(items)
            if side is not None:
                main.wait_stream(side)
                for bp, vfin, _ in got:
                    bp.record_stream(main)
                    vfin.record_stream(main)
            for k, o in zip(ks, got):
                outs[k] = o
            record["ctas"].append({"kernel": kernel, "blocks": len(ks)})
    engines = [b[2] for b in batch]
    with stats.stage("traceback", device):
        starts, bests = _start_states(engines, outs)
        for best in torch.stack(bests).cpu().tolist():
            if best <= float(NEG) / 2:
                raise RuntimeError("No feasible path found in HMM")
        walks = event_walk_batch([(o[0], s, eng.n) for eng, o, s in
                                  zip(engines, outs, starts)])
        record["ctas"].append({"kernel": "event_walk",
                               "blocks": len(batch)})
        for (i, gold, eng, _, dnalen), (ev, fb, cnt) in zip(batch, walks):
            out[i] = (condensed_path_events(ev, cnt, fb, dnalen,
                                            gold.sg.state_types), gold)
    record["batches"] += 1


def decode_pieces(model, piece_inputs: List[dict], device=None) -> list:
    """Decode many sequence pieces in flight: [(path, gold), ...] parallel
    to piece_inputs (dicts of codes, softmask, gff_hints, init_synch,
    term_synch, as augustus_tpu/parallel/mesh.py:decode_pieces takes them),
    path the condensed PathState list that the sequential `_decode` gives
    the piece, gold its GoldEngine (the hint state that the output reads).

    The pieces are prepared in order on their routes; a batch is launched
    when the next piece's resident bytes would take it past the budget
    (memory_budget), and at the end.  Each batch runs one launch per
    kernel with one block per piece, the walk starts on the card and one
    batched event walk.  Raises for a piece that the sequential path
    refuses."""
    from ..predict import _engine, _new_gold, resolve_device
    device = resolve_device(device)
    budget = memory_budget(device)
    out = [None] * len(piece_inputs)
    record = {"batches": 0, "ctas": [], "bytes_per_base": {},
              "budget_bytes": budget,
              "cached_free_bytes": cached_free_bytes(device)}
    batch, used = [], 0
    for i, pi in enumerate(piece_inputs):
        gold = _new_gold(model, pi["init_synch"], pi["term_synch"])
        eng, _ = _engine(gold, pi["codes"], pi["softmask"], pi["gff_hints"],
                         device, model.route)
        inputs = eng.inputs()
        nbytes = _resident_bytes(eng, inputs)
        dnalen = pi["codes"].shape[0]
        record["bytes_per_base"][_kernel(eng)] = max(
            record["bytes_per_base"].get(_kernel(eng), 0.0),
            nbytes / max(dnalen, 1))
        if batch and used + nbytes > budget:
            _decode_batch(batch, device, out, record)
            batch, used = [], 0
        batch.append((i, gold, eng, inputs, dnalen))
        used += nbytes
    if batch:
        _decode_batch(batch, device, out, record)
    decode_pieces.last = record
    return out


decode_pieces.last = None
