"""Pieces decoded across processes, with `torch.distributed`.

Port of `augustus_tpu/parallel/distributed.py`.  There every process joins
the JAX distributed runtime, builds the same host arrays (the prep is
replicated), the batch is sharded over the global mesh's "data" axis and
the per-piece results are allgathered back to every host
(`multihost_utils.process_allgather`), so that each prints its own copy
(the reference's cluster job lists and join_aug_pred.pl merge).

Here:
* `init(coordinator, num_processes, process_id)` joins a gloo process
  group at tcp://coordinator (nothing on a machine tells a program of a
  cluster: the caller gives the address, the world size and the rank);
* `decode_pieces_global(model, piece_inputs, device)`: every rank collects
  the host state of every piece (the hints that the output reads), rank r
  decodes the contiguous block r of the pieces on its device with
  parallel.mesh.decode_pieces (the shard of axis 0 that P("data") gives
  it), and `all_gather_object` gives every rank every piece's path.

The backend is gloo because what is gathered are host objects (PathState
lists); it also lets several ranks share one card, which NCCL refuses.
augustus_tpu's psum'd total is dropped by its callers and has no
counterpart.
"""

from __future__ import annotations

import datetime
from typing import List

import torch.distributed as dist

# seconds that a collective waits for the other ranks before it raises
TIMEOUT_S = 600


def init(coordinator: str, num_processes: int, process_id: int,
         timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group of num_processes ranks as rank process_id;
    coordinator is "host:port" of rank 0's rendezvous."""
    dist.init_process_group(
        "gloo", init_method="tcp://" + coordinator,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def block(n: int, world: int, rank: int) -> range:
    """The pieces of rank `rank`: its contiguous block of ceil(n / world)
    (the last ranks' blocks may be shorter or empty)."""
    per = -(-n // world)
    return range(min(n, rank * per), min(n, (rank + 1) * per))


def decode_pieces_global(model, piece_inputs: List[dict], device=None):
    """parallel.mesh.decode_pieces over the ranks of the process group:
    every rank calls it with the same inputs and gets [(path, gold), ...]
    for every piece."""
    from ..predict import _new_gold
    from .mesh import decode_pieces
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = block(len(piece_inputs), world, rank)
    decoded = decode_pieces(model, [piece_inputs[i] for i in mine], device)
    gathered = [None] * world
    dist.all_gather_object(gathered, [path for path, _ in decoded])
    paths = [p for part in gathered for p in part]
    golds = []
    for i, pi in enumerate(piece_inputs):
        if i in mine:
            golds.append(decoded[i - mine.start][1])
            continue
        # the host state that the output reads (gold.has_hints, the hint
        # groups of the evidence blocks), collected as the decoding rank did
        gold = _new_gold(model, pi["init_synch"], pi["term_synch"])
        gold.collect_hints(pi["codes"], pi["softmask"], pi["gff_hints"])
        golds.append(gold)
    return list(zip(paths, golds))
