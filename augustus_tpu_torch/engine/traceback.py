"""Viterbi traceback from the packed backpointer plane.

Port of `augustus_tpu/engine/traceback.py`.  Every route walks by events:

* the event walk K4 (`event_walk`, counterpart of `make_event_trace_fn`,
  and of `make_trace_fn` / `make_trace_body`, the reference's per-base
  walks of its host route and of its batched pieces): on the card it runs
  csrc/trace.cu over the plane where the Viterbi kernel left it, K1's
  (n, 64) or K2's (n, S), in launches of at most M_EVENTS events, and only
  the events and four ints a launch come back; `event_walk_batch` walks the
  planes of many pieces in one launch, one block each (parallel/mesh.py);
  `condensed_path_events` builds the PathState list from the events.
* the per-base walk (`trace_packed`), kept for host arrays and the tests:
  the reference walks with a backwards `lax.scan` (`make_trace_fn`); here
  numpy walks a host copy of the plane.  It emits one packed int32 per base
  j = 1 .. n-1, as the reference does:

    bits 0..7   state id at this base
    bit  30     set if a raw segment ENDS here (a backpointer was read)

Runs of self-loop reads (off == 1, pred == state: the per-base chain
states) are filled in one step from a running-max table, so the Python loop
runs once per real segment.  `raw_segments` and `condensed_path` rebuild the
exact segment list / condensed PathState list from the emits.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

FLAG_BIT = 30
M_EVENTS = 16384         # the event walk's bound (the reference's M)


def trace_packed(bp: np.ndarray, state0: int, n: int
                 ) -> Tuple[np.ndarray, int]:
    """(emits (n-1,) int32 for j=1..n-1, final_base) of the walk over the
    kernel plane bp (row j = backpointers at base j; pred = bp >> 20,
    off = bp & 0xFFFFF; segment [j-off+1, j], next (j-off, pred)).
    Same carry evolution as the reference `make_trace_fn(n, 0)`."""
    emits = np.zeros(max(n - 1, 0), dtype=np.int32)
    if n <= 1:
        return emits, n - 1
    body = bp[:n]
    off_t = body & 0xFFFFF
    pred_t = body >> 20
    selfrun = (off_t == 1) & (pred_t == np.arange(body.shape[1])[None, :])
    selfrun[:2] = False                      # base 1 always reads
    jcol = np.where(selfrun, np.int32(0),
                    np.arange(n, dtype=np.int32)[:, None])
    brk = np.maximum.accumulate(jcol, axis=0)    # last non-self j' <= j
    flag = np.int32(1 << FLAG_BIT)
    rb, st = n - 1, int(state0)
    while rb >= 1:
        if selfrun[rb, st]:
            b2 = int(brk[rb, st])            # bases (b2, rb] read off=1
            emits[b2: rb] = st | flag
            rb = b2
            if rb < 1:
                break
        packed = int(body[rb, st])
        off, pred = packed & 0xFFFFF, packed >> 20
        if off < 1:
            raise RuntimeError(f"invalid backpointer at base {rb}, "
                               f"state {st}")
        lo = max(rb - off + 1, 1)
        emits[lo - 1: rb] = st
        emits[rb - 1] = st | flag
        rb, st = rb - off, pred
    return emits, rb


def raw_segments(packed: np.ndarray, final_base: int, types
                 ) -> List[Tuple[int, int, object]]:
    """Exact raw segment list of the host walk from the packed emits."""
    states = packed & 0xFF
    ends = np.flatnonzero((packed >> FLAG_BIT) & 1) + 1    # j values
    begins = np.empty_like(ends)
    begins[0] = final_base + 1     # last walk base (may be -1 -> begin 0)
    begins[1:] = ends[:-1] + 1
    st = states[ends - 1]
    return [(int(b), int(e), types[int(s)])
            for b, e, s in zip(begins, ends, st)]


def condensed_path(packed: np.ndarray, final_base: int, dnalen: int, types):
    """List[PathState] identical to og.condense_path(raw_segments(...)).

    Merges adjacent same-type non-coding-exon runs with numpy instead of a
    per-raw-segment Python loop (chain states emit one raw segment per
    base).  Truncation flags can only be set on raw segments touching the
    sequence ends (set_trunc_flag needs pred_end in (-1, 0) or
    end == dnalen-1), so they are evaluated on the first/last raw segment
    only.
    """
    from ..output.genes import (PathState, set_trunc_flag, is_coding_exon)

    states = packed & 0xFF
    flags = (packed >> FLAG_BIT) & 1
    ends = np.flatnonzero(flags) + 1
    if ends.size == 0:
        return []
    begins = np.empty_like(ends)
    begins[0] = final_base + 1     # last walk base (may be -1 -> begin 0)
    begins[1:] = ends[:-1] + 1
    segt = states[ends - 1]

    # type-ids: merge run k into k-1 when same type and not a coding exon
    ptypes = [types[int(s)] for s in segt]
    coding = np.array([is_coding_exon(t) for t in ptypes], dtype=bool)
    same = np.zeros(ends.size, dtype=bool)
    same[1:] = (segt[1:] == segt[:-1]) & ~coding[1:]
    run_start = np.flatnonzero(~same)
    run_end = np.empty_like(run_start)
    run_end[:-1] = run_start[1:] - 1
    run_end[-1] = ends.size - 1

    out = []
    for rs, re in zip(run_start, run_end):
        st = PathState(begin=int(begins[rs]), end=int(ends[re]),
                       type=ptypes[rs])
        probe = PathState(begin=int(begins[rs]), end=int(ends[rs]),
                          type=ptypes[rs])
        set_trunc_flag(probe, int(begins[rs]) - 1, dnalen)
        trunc = probe.truncated
        if re != rs:
            probe2 = PathState(begin=int(begins[re]), end=int(ends[re]),
                               type=ptypes[re])
            set_trunc_flag(probe2, int(begins[re]) - 1, dnalen)
            trunc |= probe2.truncated
        st.truncated = trunc
        out.append(st)
    return out


# --------------------------------------------------------------------------
# the event walk K4: CUDA kernel and plain version
# --------------------------------------------------------------------------

def walk_breaks(bp: torch.Tensor, n: int) -> torch.Tensor:
    """brk (W, n-1) int32, lane-major, for a plane bp of W states: brk[s, i]
    is the last base j' <= i+1 whose read of state s is not a self loop
    (off == 1 and pred == s; base 1 always reads), the running maximum of
    the reference's `jcol` table (torch.cummax as lax.cummax there: exact
    on integers).  Each state's row is one contiguous scan (a scan down the
    columns of the (n, W) plane runs one thread per state)."""
    body = bp[1:n].t().contiguous()                 # (W, n-1)
    lane = torch.arange(body.shape[0], dtype=torch.int32, device=bp.device)
    selfrun = ((body & 0xFFFFF) == 1) & ((body >> 20) == lane[:, None])
    selfrun[:, 0] = False
    jj = torch.arange(1, n, dtype=torch.int32, device=bp.device)
    jcol = torch.where(selfrun, torch.zeros_like(body), jj[None, :])
    return torch.cummax(jcol, dim=1).values


def event_walk_reference(bp: torch.Tensor, brk: torch.Tensor, state0: int,
                         n: int, M: int = M_EVENTS, base0=None):
    """The walk of `make_event_trace_fn` over a plane of any width from
    state0 at base0 (n-1 when None), one Python step per event, for at most
    M events: (events (M, 5) int32, final base, final state, count).  Event
    rows are [run_lo, run_hi, seg_lo, seg_hi, state], end to begin; rows
    past count are 0.  A backpointer with off < 1 never moves the walk: it
    raises, where the reference would repeat it until M."""
    ev = torch.zeros((M, 5), dtype=torch.int32, device=bp.device)
    base = n - 1 if base0 is None else int(base0)
    state, count = int(state0), 0
    while count < M and base > 0:
        p = int(bp[base, state])
        selfrun = base >= 2 and (p & 0xFFFFF) == 1 and (p >> 20) == state
        b2 = int(brk[state, base - 1]) if selfrun else base
        packed = int(bp[b2, state])
        off, pred = packed & 0xFFFFF, packed >> 20
        if off < 1:
            raise RuntimeError(f"invalid backpointer at base {b2}, state "
                               f"{state}")
        ev[count] = torch.tensor([b2 + 1, base, b2 - off + 1, b2, state],
                                 dtype=torch.int32)
        base, state = b2 - off, pred
        count += 1
    return ev, base, state, count


def _check_plane(bp: torch.Tensor, n: int) -> None:
    if bp.dtype != torch.int32 or bp.dim() != 2 or bp.shape[0] < n \
            or bp.shape[1] < 1:
        raise ValueError(f"bp must be (n, W) int32, got "
                         f"{tuple(bp.shape)} {bp.dtype}")
    if bp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bp.device}")


def _check_state(state0: int, W: int) -> None:
    if not 0 <= state0 < W:
        raise ValueError(f"start state {state0} outside the plane's {W} "
                         f"states")


def event_walk(bp: torch.Tensor, state0: int, n: int, M: int = M_EVENTS):
    """(events (count, 5) numpy int32, final base, count) of the whole walk
    from state0 at base n-1 over a Viterbi kernel's plane bp ((n, W) int32,
    row j = base j: W = 64 for K1's plane, S for K2's).  The walk runs in
    steps of at most M events (the reference's bound), each step starting
    where the last one stopped, until it reaches base 0; every step runs
    where bp lies.  CPU tensors run the plain version; CUDA tensors launch
    csrc/trace.cu (and raise if it does not build or launch).
    `event_walk.launches` counts kernel launches (event_walk_batch's
    included)."""
    _check_plane(bp, n)
    _check_state(int(state0), bp.shape[1])
    if n < 2:
        return np.zeros((0, 5), np.int32), n - 1, 0
    brk = walk_breaks(bp, n).contiguous()
    bpc = bp.contiguous()
    parts, base, state = [], n - 1, int(state0)
    while base > 0:
        if bp.device.type == "cpu":
            ev, base, state, cnt = event_walk_reference(bpc, brk, state, n,
                                                        M, base)
        else:
            ev, res = launch_event_walk(bpc, brk, state, n, M, base)
            base, state, cnt, bad = (int(v) for v in res.cpu())
            if bad:
                raise RuntimeError(f"invalid backpointer at base {base}, "
                                   f"state {state}")
        parts.append(ev[:cnt].cpu().numpy())
    events = np.concatenate(parts)
    return events, base, events.shape[0]


def launch_event_walk(bp: torch.Tensor, brk: torch.Tensor, state0: int,
                      n: int, M: int = M_EVENTS, base0=None):
    """One launch of csrc/trace.cu on CUDA tensors (bp (n, W) and brk
    (W, n-1) int32, contiguous), from state0 at base0 (n-1 when None), for
    at most M events: (events (M, 5), [final base, final state, count,
    invalid backpointer]) on the card, not synchronized."""
    from ._build import load
    fn = load("trace").event_walk_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    ev = torch.zeros((M, 5), dtype=torch.int32, device=bp.device)
    res = torch.zeros(4, dtype=torch.int32, device=bp.device)
    err = fn(bp.data_ptr(), brk.data_ptr(), n, bp.shape[1],
             n - 1 if base0 is None else int(base0), int(state0), M,
             ev.data_ptr(), res.data_ptr(),
             torch.cuda.current_stream(bp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"event_walk kernel launch failed: CUDA error "
                           f"{err}")
    event_walk.launches += 1
    return ev, res


event_walk.launches = 0
event_walk.batched_launches = 0
event_walk.largest_grid = 0

# the int64 fields of a record of csrc/trace.cu's batched walk (R_BP ..)
WALK_FIELDS = ("bp", "brk", "events", "result", "n", "W", "base", "state")


def event_walk_batch(walks, M: int = M_EVENTS) -> list:
    """event_walk of every (bp, state0, n) of `walks`, on one device:
    [(events, final base, count)] in their order.  state0 is an int or, on
    the card, a one-element integer tensor there (the argmax of the final
    column, never copied to the host).

    CPU tensors run the plain version plane after plane.  On the card, one
    launch of csrc/trace.cu walks every plane, one block each, for at most
    M events; the planes whose walk has not reached base 0 are relaunched
    together from their last base and state, the others are not, until
    every walk ends.  Only the events and four ints a plane come back.
    `event_walk.batched_launches` counts these launches and
    `event_walk.largest_grid` records the most planes one of them took."""
    out = [None] * len(walks)
    if not walks:
        return out
    dev = walks[0][0].device
    for bp, state0, n in walks:
        _check_plane(bp, n)
        if bp.device != dev:
            raise ValueError(f"planes on {bp.device} and {dev}")
        if not isinstance(state0, torch.Tensor):
            _check_state(int(state0), bp.shape[1])
    if dev.type == "cpu":
        return [event_walk(bp, int(state0), n, M) for bp, state0, n in walks]
    live, rows, states, bufs = [], [], [], {}
    for i, (bp, state0, n) in enumerate(walks):
        if n < 2:
            out[i] = (np.zeros((0, 5), np.int32), n - 1, 0)
            continue
        bpc = bp.contiguous()
        brk = walk_breaks(bpc, n).contiguous()
        ev = torch.zeros((M, 5), dtype=torch.int32, device=dev)
        res = torch.zeros(4, dtype=torch.int32, device=dev)
        bufs[i] = (bpc, brk, ev, res, [])
        live.append(i)
        rows.append([bpc.data_ptr(), brk.data_ptr(), ev.data_ptr(),
                     res.data_ptr(), n, bp.shape[1], n - 1, 0])
        states.append(torch.as_tensor(state0, device=dev).reshape(()))
    if not live:
        return out
    recs = torch.tensor(rows, dtype=torch.int64).to(dev)
    recs[:, WALK_FIELDS.index("state")] = torch.stack(states).to(torch.int64)
    while live:
        _launch_walk_batch(recs, len(live), M)
        res_h = torch.stack([bufs[i][3] for i in live]).cpu().tolist()
        again = []
        for i, row, (base, state, cnt, bad) in zip(live, rows, res_h):
            if bad:
                raise RuntimeError(f"invalid backpointer or start at base "
                                   f"{base}, state {state}")
            parts = bufs[i][4]
            parts.append(bufs[i][2][:cnt].cpu().numpy())
            if base > 0:
                row[6:8] = [base, state]
                again.append((i, row))
            else:
                events = np.concatenate(parts)
                out[i] = (events, base, events.shape[0])
        live = [i for i, _ in again]
        rows = [row for _, row in again]
        if rows:
            recs = torch.tensor(rows, dtype=torch.int64).to(dev)
    return out


def _launch_walk_batch(recs: torch.Tensor, P: int, M: int) -> None:
    from ._build import load
    fn = load("trace").event_walk_batch_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(recs.data_ptr(), P, M,
             torch.cuda.current_stream(recs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"event_walk batch launch failed: CUDA error "
                           f"{err}")
    event_walk.launches += 1
    event_walk.batched_launches += 1
    event_walk.largest_grid = max(event_walk.largest_grid, P)


def path_by_events(bp: torch.Tensor, state0: int, n: int, dnalen: int,
                   types):
    """The condensed PathState list of the event walk over the plane bp
    from state0 (the engines' traceback_path)."""
    ev, fb, cnt = event_walk(bp, state0, n)
    return condensed_path_events(ev, cnt, fb, dnalen, types)


def condensed_path_events(events: np.ndarray, count: int, final_base: int,
                          dnalen: int, types):
    """List[PathState] from the event walk's output; identical to
    condensed_path on the per-base packed emits (chain runs expand to
    per-base raw segments, then adjacent same-type non-coding-exon runs
    merge: they are by construction the same merged run)."""
    from ..output.genes import (PathState, set_trunc_flag, is_coding_exon)
    ev = np.asarray(events[:count][::-1])          # begin-to-end order
    if ev.shape[0] == 0:
        return []
    # per event: read segment [seg_lo, seg_hi], then run [run_lo, run_hi]
    segs: List[Tuple[int, int, int]] = []
    for run_lo, run_hi, seg_lo, seg_hi, st_ in ev:
        segs.append((int(seg_lo), int(seg_hi), int(st_)))
        if run_hi >= run_lo:
            t = types[int(st_)]
            if is_coding_exon(t):      # never self-runs; safety expansion
                segs.extend((p, p, int(st_))
                            for p in range(int(run_lo), int(run_hi) + 1))
            else:
                segs.append((int(run_lo), int(run_hi), int(st_)))
    out = []
    for b, e, s in segs:
        t = types[s]
        if out and out[-1].type == t and not is_coding_exon(t):
            out[-1].end = e
            continue
        out.append(PathState(begin=b, end=e, type=t))
    # truncation flags: only the first/last raw segments can set them
    for st in out:
        probe = PathState(begin=st.begin, end=st.end, type=st.type)
        set_trunc_flag(probe, st.begin - 1, dnalen)
        st.truncated = probe.truncated
    return out
