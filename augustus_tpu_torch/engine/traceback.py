"""Viterbi traceback on the host, from the packed backpointer plane.

Port of `augustus_tpu/engine/traceback.py`.  The reference walks the path on
the device with a backwards `lax.scan` (`make_trace_fn`); here the (n, 64)
backpointer plane is copied to the host once and walked with numpy.  The
walk emits one packed int32 per base j = 1 .. n-1, as the reference does:

    bits 0..7   state id at this base
    bit  30     set if a raw segment ENDS here (a backpointer was read)

Runs of self-loop reads (off == 1, pred == state: the per-base chain
states) are filled in one step from a running-max table, so the Python loop
runs once per real segment.  `raw_segments` and `condensed_path` rebuild the
exact segment list / condensed PathState list from the emits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FLAG_BIT = 30


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
