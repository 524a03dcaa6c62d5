"""Stage timers and counters of the prediction pipeline.

Port of `augustus_tpu/stats.py`: a per-stage breakdown (prep / dev_prep /
track build / pack / expand / kernel / forward / traceback / sample / gene
projection / MEA / printing / cut-point exams), enabled by `reset(True)`;
`predict` and the engine call `stats.stage(name)` unconditionally.  When
disabled, a stage is one flag check: no event, no profiler span, no
dispatch mode.

When enabled, every stage is a `torch.profiler.record_function` span named
`stage:<name>`, and its host wall time is added up:

* `stage(name)` (no device, or a CPU device): `TIMES[name]` is host time
  (`prep`, `exam`, `project`, `print`; `sample`: the host sampling walk
  and the projection of the sampled paths; `mea`: the MEA graph and its
  longest path, output/mea.py).
* `stage(name, device)` on a CUDA device: `TIMES["host:" + name]` is host
  time, and `TIMES[name]` device time, from CUDA events recorded on the
  device's current stream at the stage's start and end (`dev_prep`,
  `expand`, `kernel`, `traceback`; `forward`: the forward table's plane
  expansion and kernel).  No stage synchronizes: the event pairs wait on a
  pending list until `flush()`, which `predict.predict_sequence` calls once
  the record's outputs are on the host, and which every read of
  `stats.TIMES` calls first.

`count(name)` counts events: the route of every piece (`device_prep` or
`host_prep`), the cut-point exams (`exams`) and the cuts (`cuts`), and,
inside `dispatch_counts(prefix, device)`, the ATen operations of the
first block of `prefix` after `reset` (`<prefix>_ops`, `<prefix>_syncs`,
`<prefix>_h2d_bytes`; see `transfer`).

An operator's timeline: run the program inside `torch.profiler.profile`
(with the CUDA activity on a card) after `stats.reset(True)`; the trace
then holds the `stage:<name>` spans beside the device's kernels and copies,
on one clock.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SPAN_PREFIX = "stage:"

_ENABLED = False
_TIMES: Dict[str, float] = {}
COUNTS: Dict[str, int] = {}
# CUDA stages whose device time is not yet read: (name, start, end)
_PENDING: List[tuple] = []
_OFF = contextlib.nullcontext()
# prefixes whose first block dispatch_counts has counted since reset
_COUNTED: Set[str] = set()
_COUNTER: Optional["_OpCounter"] = None   # the block being counted


def __getattr__(name: str):
    # `stats.TIMES` resolves the pending device times before it is read
    if name == "TIMES":
        flush()
        return _TIMES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset(enabled: bool = True) -> None:
    global _ENABLED
    _ENABLED = enabled
    _TIMES.clear()
    COUNTS.clear()
    _PENDING.clear()
    _COUNTED.clear()


def count(name: str, k: int = 1) -> None:
    if _ENABLED:
        COUNTS[name] = COUNTS.get(name, 0) + k


def add(name: str, seconds: float) -> None:
    if _ENABLED:
        _TIMES[name] = _TIMES.get(name, 0.0) + seconds


def flush() -> None:
    """Add the device time of every pending CUDA stage to TIMES.  Waits
    only for an end event that has not completed yet."""
    pending = list(_PENDING)
    _PENDING.clear()
    for name, start, end in pending:
        if not end.query():
            end.synchronize()
        add(name, start.elapsed_time(end) / 1000.0)


def stage(name: str, device=None):
    """A context that times the enclosed work as stage `name` (see the
    module docstring)."""
    if not _ENABLED:
        return _OFF
    return _stage(name, device)


@contextlib.contextmanager
def _stage(name: str, device):
    cuda = getattr(device, "type", None) == "cuda"
    with torch.profiler.record_function(SPAN_PREFIX + name):
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t0
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                _PENDING.append((name, start, end))
                add("host:" + name, host)
            else:
                add(name, host)


# ---- operations of a block, read at the dispatcher ----------------------

_COPIES = frozenset(("_to_copy", "copy_", "_copy_from",
                     "_copy_from_and_resize"))
# ops whose result the host waits for: a value read back, or an output
# whose size depends on the data
_BLOCKING = frozenset(("_local_scalar_dense", "equal", "nonzero",
                       "masked_select", "_unique", "_unique2", "unique_dim",
                       "unique_consecutive", "unique_dim_consecutive",
                       "repeat_interleave", "bincount"))
_INDEX = frozenset(("index", "index_put", "index_put_", "_index_put_impl_"))


def transfer(op: str, src: Optional[str], dst: Optional[str],
             non_blocking: bool) -> Tuple[bool, bool]:
    """(syncs, h2d) of one ATen op (its name without namespace and
    overload) that reads a tensor on device type `src` and leaves its
    result on `dst` (None: no tensor there): whether the host waits until
    the card's stream drains, and whether it copies host memory to the
    card.

    A copy between host and card blocks unless `non_blocking`; a copy
    within one side never does.  On the card, reading a value back
    (`_local_scalar_dense`: `.item()`, `bool()`, `float()`; `equal`) and
    ops whose output size depends on the data (`nonzero`,
    `masked_select`, `unique`, `repeat_interleave` with a tensor of
    repeats, `bincount`, an index by a boolean mask) block."""
    if op in _COPIES:
        h2d = src == "cpu" and dst == "cuda"
        d2h = src == "cuda" and dst == "cpu"
        return (h2d or d2h) and not non_blocking, h2d
    return src == "cuda" and op in _BLOCKING, False


def _device_type(x) -> Optional[str]:
    """The device type of a tensor, or of the first item of a list of
    tensors; None otherwise."""
    if isinstance(x, (list, tuple)):
        x = x[0] if x else None
    return x.device.type if isinstance(x, torch.Tensor) else None


def _bool_mask(indices) -> bool:
    return any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                           torch.uint8)
               for t in indices or ())


_VIEW, _PLAIN, _OTHER = range(3)


# one cache entry per ATen op overload, each of which lives as long as the
# process
@functools.cache
def _op_kind(func) -> Tuple[int, str]:
    """(kind, name) of an ATen op: a view, an op that `transfer` gives
    (False, False) whatever its devices, or one it has to classify."""
    op = func._schema.name.split("::")[-1]
    if func.is_view:
        return _VIEW, op
    if op in _COPIES or op in _BLOCKING or op in _INDEX:
        return _OTHER, op
    return _PLAIN, op


class _OpCounter(TorchDispatchMode):
    """Counts the non-view ATen ops that touch one device type, those of
    them that block the host, and the bytes copied from the host to the
    card."""

    # the port never compiles with dynamo; leaving __torch_dispatch__
    # unwrapped by torch._disable_dynamo keeps the cost of counting down
    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.ops = self.syncs = self.h2d_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **kwargs) if kwargs else func(*args)
        kind, op = _op_kind(func)
        if kind == _PLAIN:
            self.ops += _device_type(out) == self.device_type
            return out
        if kind == _VIEW:
            return out
        kwargs = kwargs or {}
        if op == "copy_":
            dst, src = args[0], args[1]
            non_blocking = bool(args[2] if len(args) > 2
                                else kwargs.get("non_blocking", False))
        else:
            dst, src = out, args[0] if args else None
            non_blocking = bool(kwargs.get("non_blocking", False))
            if op in _INDEX and len(args) > 1 and _bool_mask(args[1]):
                op = "nonzero"      # the op runs nonzero on the mask
        self.add(op, _device_type(src), _device_type(dst), non_blocking,
                 dst)
        return out

    def add(self, op: str, src_t: Optional[str], dst_t: Optional[str],
            non_blocking: bool, dst) -> None:
        """Count one op from device type `src_t` to `dst_t` (None: no
        tensor there) if either is the counted one; `dst`: its result."""
        if self.device_type not in (src_t, dst_t):
            return
        self.ops += 1
        syncs, h2d = transfer(op, src_t, dst_t or "cpu", non_blocking)
        self.syncs += syncs
        if h2d:
            t = dst[0] if isinstance(dst, (list, tuple)) else dst
            self.h2d_bytes += t.numel() * t.element_size()


def dispatch_counts(prefix: str, device):
    """A context that counts the enclosed block's ATen ops on `device`
    into COUNTS, for the first block of `prefix` after `reset`
    (`<prefix>_counted` is then 1): `<prefix>_ops` (ops that are not
    views), `<prefix>_syncs` (those that block the host, `transfer`) and
    `<prefix>_h2d_bytes` (bytes copied from the host to the card).  The
    device preparation issues the same ops and syncs whatever the piece,
    and counting costs the host about as much again as the ops
    themselves, so one block is counted.  It gives the block's counter
    (`ops` may be raised for work launched outside ATen, such as a ctypes
    kernel), or None when the block is not counted."""
    if not _ENABLED or prefix in _COUNTED:
        return _OFF
    _COUNTED.add(prefix)
    return _dispatch_counts(prefix, torch.device(device).type)


@contextlib.contextmanager
def _dispatch_counts(prefix: str, device_type: str):
    global _COUNTER
    mode = _OpCounter(device_type)
    outer, _COUNTER = _COUNTER, mode
    try:
        with mode:
            yield mode
    finally:
        _COUNTER = outer
        count(prefix + "_counted")
        count(prefix + "_ops", mode.ops)
        count(prefix + "_syncs", mode.syncs)
        count(prefix + "_h2d_bytes", mode.h2d_bytes)


def upload(t: torch.Tensor) -> None:
    """Count, in the block being counted, the tensor `t` that torch made
    on its device from Python data on the host (`torch.as_tensor` or
    `torch.tensor` of a number or a list): a blocking copy from the host,
    made below the dispatcher, where the block's mode does not see it."""
    if _COUNTER is not None and t.device.type != "cpu":
        _COUNTER.add("_to_copy", "cpu", t.device.type, False, t)
