#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (augustus_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernels from the sources in the
checkout, and exits non-zero on any failure (nothing is caught, nothing
falls back to the CPU or to a kernel's plain version).  Phases, one JSON
line each:

  device  card name and power limit (nvidia-smi)
  build   nvcc of csrc/viterbi.cu, prefix.cu, trace.cu and forward.cu,
          all started together (set-up time; nvcc's -Xptxas=-v report of
          registers, shared memory and spills goes to stderr)
  parity  the Viterbi kernel against its plain PyTorch version on the card,
          on 6 kb of tests/data/HS04636.fa with the repo_fixture species,
          with the two-GC-class species repo_fixture_gc2 (a class switch
          inside the chunk), on all of HS04636.fa, the chunk that the gff
          phase gives the kernel, and on two chunks with sparse exon/CDS
          hints (NHW > 0), which run the hint quotient K1.f: all of
          tests/data/HS04636sm.fa softmasked with its EST hints (the chunk
          of the gff_hints phase) and 6 kb of HS04636rc.fa with the mirrored
          (minus-strand) hints: per-step values bit-equal (tolerance 0),
          live backpointers equal, final column equal; the kernel's time
          and time per position beside its roofline bound, with the bytes
          per position
  prep_parity  the device route's tables (engine/device_prep.py: track
          preparation on the card, float64, prefix.cu for the cumulative
          sums) against the host route's (numpy) on the card, for all of
          HS04636.fa, the gc2 6 kb chunk, HS04636sm.fa softmasked with the
          exon-free subset of its hints, and the full 1.02 Mb tiled_record:
          PKStatic equal, integer tables exact, float tables bit-equal (the
          count of entries that are not and the largest difference are
          printed)
  kernels_new  on the full cell: prefix.cu against its plain version
          (torch.cumsum on the CPU) and np.cumsum on every row that the
          device route sums (bit-equal), with torch.cumsum on the card as
          the library call and the count of float32 table entries it would
          have changed; trace.cu (the event walk K4) against its plain
          version on the full cell's backpointer plane (events, count,
          final base and state equal), and the walk with a bound of
          count // 3 + 1 events (three launches, each from where the last
          stopped) equal to one launch, beside the host walk it replaces
  forward_parity  the forward-table kernel (csrc/forward.cu) against its
          plain PyTorch version on the card, on every piece that the main
          path gives it, built as the sampled runs build them (host route):
          all of HS04636.fa (gff_sample), all of HS04636sm.fa with its EST
          hints (the hinted gff_sample run: sparse hints, the hint quotient)
          and the first SAMPLE_DEPTH bases of the full cell's sequence
          (sample_depth); besides, 6 kb of HS04636.fa with repo_fixture_gc2
          (a GC-class switch) and at --temperature=3 (heated tables): the
          same finite support and |df| <= 4e-3 + 3e-6 * |f| (the sums run in
          another order); max |df|, kernel and plain ms, the bound from the
          bytes of forward_work and the exp/log count of the plain version
  gff     prediction on HS04636.fa on the card (device route), cold and
          warm, each byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_HS04636.gff
  gff_hints  the same on HS04636sm.fa with --softmasking=1, its hints
          file and extrinsic.M.RM.E.W.cfg (exon hints: host route),
          evidence blocks included, byte-equal to
          repo_fixture_HS04636sm_hints.gff
  gff_sample  HS04636.fa with --sample=100
          --alternatives-from-sampling=true (host route, the Viterbi and
          forward kernels, the host sampling walk): cold through the
          command line (python -m augustus_tpu_torch.cli.augustus, a
          process of its own), warm through predict_records with a fresh
          model (a fresh rand() stream), each byte-equal to
          repo_fixture_HS04636_sample100.gff; then HS04636sm.fa with its
          hints, sampled with the posterior filters --minexonintronprob,
          --minmeanexonintronprob and --keep_viterbi (the hint quotient in
          the forward kernel, the hint terms in the walk), warm, byte-equal
          to repo_fixture_HS04636sm_hints_sample100.gff
  full    ab-initio prediction on the 1,023,095-base sequence of
          augustus_tpu_torch/io/tiled.py (device route): one cold run, then
          one warm run with the per-stage breakdown, each byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_tiled.gff
  full_sm the same letters softmasked (io/tiled.py:tiled_hinted) with the
          hints of data/hints/tiled_sm.E.gff without their exonpart,
          CDSpart, exon and CDS lines: the device route cold and warm, then
          the host route (Model.route = "host") cold and warm, all four
          GFF texts byte-equal, evidence blocks included
  full_hints  the softmasked letters with all the EST hints of every
          inserted gene (host route), cold and warm, each byte-equal to
          repo_fixture_tiled_hints.gff
  full_forward  the forward kernel on the full cell's planes (device
          route) and on full_hints' (host route): its time and time per
          position, the same finite support as the Viterbi kernel's values
          (debug_vals) and f >= v - (4e-3 + 3e-6 * |v|) everywhere (a
          logsumexp is at least the maximum)
  sample_depth  the sampled prediction of gff_sample on the first
          SAMPLE_DEPTH bases of the full cell's sequence: seconds of the
          host walk per Mb of sequence and per sampled Mb
Every prediction phase prints the route of each piece (stats counts) and
asserts the one it expects.  Then the kernels line, the card line and the
final status line.  The golden comparisons leave out comment lines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN_DIR = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
DATA = os.path.join(ROOT, "tests", "data")

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# the float32 and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# exp and log: 16 results per clock per SM on compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput), 132 SMs at the
# 1,980 MHz boost clock of the H100 SXM
SFU_OPS_PER_S = 132 * 16 * 1.98e9
KERNELS = ("viterbi", "prefix", "trace", "forward")
FWD_ABS_TOL, FWD_REL_TOL = 4e-3, 3e-6
SAMPLE_ARGS = {"sample": "100", "alternatives-from-sampling": "true"}
# the posterior filters of the hinted sampled golden
SAMPLE_FILTERS = {"minexonintronprob": "0.08", "minmeanexonintronprob": "0.4",
                  "keep_viterbi": "true"}
SAMPLE_DEPTH = 21_000     # bases of the full cell's sequence sampled
EXON_FREE = os.path.join(ROOT, "build", "hints", "tiled_sm.exon_free.gff")
EXON_FREE_SM = os.path.join(ROOT, "build", "hints",
                            "HS04636sm.exon_free.gff")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def model_args(species: str, hints=None) -> dict:
    """The species' arguments; with a hints file (a name in data/hints or a
    path), softmasking on and the EST hints with
    extrinsic.M.RM.E.W.cfg."""
    if hints is None:
        return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
                "UTR": "off", "softmasking": "0"}
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "1",
            "hintsfile": os.path.join(HINTS, hints),
            "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}


def write_exon_free(src: str, dst: str) -> int:
    """dst: the hint lines of data/hints/src without exonpart, CDSpart, exon
    and CDS lines (io/tiled.py:exon_free_hints); returns their count."""
    from augustus_tpu_torch.io.tiled import exon_free_hints
    with open(os.path.join(HINTS, src)) as fh:
        lines = exon_free_hints(fh.read().splitlines(True))
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as fh:
        fh.write("".join(lines))
    return len(lines)


def golden_body(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return strip_comments(fh.read())


def strip_comments(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def time_cuda(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_parity(device, chunks):
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.viterbi import (
        kernel_work, viterbi_forward, viterbi_forward_reference)
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_planes
    rows = []
    for species, fasta, n, hints in chunks:
        rec = read_fasta(os.path.join(DATA, fasta))[0]
        st, planes, gold = piece_planes(
            Model.load(model_args(species, hints)), rec, n, device)
        switches = int((gold.stairs[1:] != gold.stairs[:-1]).sum())
        n = st.n
        if species.endswith("gc2") and switches < 1:
            raise AssertionError("the gc2 chunk has no GC-class switch")
        if (hints is not None) != (st.NHW > 0):
            raise AssertionError(f"{fasta}: NHW={st.NHW} with hints={hints}")
        bp_k, vf_k, v_k = viterbi_forward(st, planes, debug_vals=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp_p, vf_p, v_p = viterbi_forward_reference(st, planes, True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1000.0
        S = st.S
        vk, vp = v_k[1:, :S].cpu().numpy(), v_p[1:, :S].cpu().numpy()
        live = vp > -5.0e29
        bk, bpp = bp_k[1:, :S].cpu().numpy(), bp_p[1:, :S].cpu().numpy()
        if not np.array_equal(vk.view(np.int32), vp.view(np.int32)):
            bad = np.argwhere(vk != vp)
            raise AssertionError(f"{species}: per-step values differ at "
                                 f"{bad[:5].tolist()} ({len(bad)} entries)")
        if not ((bk == bpp) | ~live).all():
            bad = np.argwhere((bk != bpp) & live)
            raise AssertionError(f"{species}: live backpointers differ at "
                                 f"{bad[:5].tolist()}")
        if not torch.equal(vf_k[:S].cpu(), vf_p[:S].cpu()):
            raise AssertionError(f"{species}: final column differs")
        kernel_ms = time_cuda(lambda: viterbi_forward(st, planes), 3)
        parts, ops_by_part = kernel_work(st, planes)
        nbytes, ops = sum(parts.values()), sum(ops_by_part.values())
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_OPS_PER_S * 1e3
        row = {"phase": "parity", "species": species, "fasta": fasta,
               "n": n, "hints": hints, "NHW": st.NHW,
               "hint_convs": sum(c.hint is not None for c in st.convs),
               "gc_switches": switches, "parity": "bit-exact",
               "tolerance": 0.0,
               "max_abs_err": float(np.abs(vk[live] - vp[live]).max()
                                    if live.any() else 0.0),
               "live_values": int(live.sum()), "kernel_ms": kernel_ms,
               "us_per_position": kernel_ms * 1e3 / n,
               "plain_ms": plain_ms, "bytes": nbytes,
               "bytes_per_position": nbytes / n, "bytes_by_part": parts,
               "ops": ops, "ops_by_part": ops_by_part,
               "bound_bytes_ms": bound_bytes_ms,
               "bound_ops_ms": bound_ops_ms,
               "bound_ms": max(bound_bytes_ms, bound_ops_ms),
               "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                            else "operations")}
        emit(row)
        rows.append(row)
    return rows


def compare_tables(host, dev):
    """The device route's packed tables against the host route's: (static
    equal, {table: integer entries that differ}, {table: float entries not
    bit-equal}, largest float difference)."""
    import numpy as np
    import torch
    (hst, harr), (dst, darr) = host, dev
    static_equal = dataclasses.asdict(hst) == dataclasses.asdict(dst)
    int_diff, not_bit_equal, max_diff = {}, {}, 0.0

    def npy(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    for k, v in harr.items():
        h, d = npy(v), npy(darr[k])
        if h.shape != d.shape or h.dtype != d.dtype:
            raise AssertionError(f"table {k}: {h.shape} {h.dtype} on the "
                                 f"host route, {d.shape} {d.dtype} on the "
                                 "device route")
        if h.dtype.kind != "f":
            bad = int((h != d).sum())
            if bad:
                int_diff[k] = bad
            continue
        bad = int((h.view(np.int32) != d.view(np.int32)).sum())
        if not bad:
            continue
        not_bit_equal[k] = bad
        hf = np.maximum(np.nan_to_num(h, neginf=-1e30), -1e30)
        df = np.maximum(np.nan_to_num(d, neginf=-1e30), -1e30)
        diff = np.abs(np.where((hf > -1e29) | (df > -1e29), hf - df, 0.0))
        max_diff = max(max_diff, float(diff.max()))
    return static_equal, int_diff, not_bit_equal, max_diff


def phase_prep_parity(device, chunks, card):
    import torch
    from augustus_tpu_torch.predict import piece_tables
    for name, model, rec, n in chunks:
        t0 = time.perf_counter()
        host, _, _ = piece_tables(dataclasses.replace(model, route="host"),
                                  rec, n, device)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dev, gold, route = piece_tables(model, rec, n, device)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        if route != "device_prep":
            raise AssertionError(f"{name}: outside the device route")
        static_equal, int_diff, nbe, max_diff = compare_tables(host, dev)
        emit({"phase": "prep_parity", "chunk": name, "n": host[0].n,
              "hints": gold.hints is not None, "static_equal": static_equal,
              "int_entries_differing": int_diff,
              "float_entries_not_bit_equal": sum(nbe.values()),
              "not_bit_equal_by_table": nbe, "max_abs_diff": max_diff,
              "host_route_s": host_s,
              "device_route_s": dev_s,
              "device_route_peak_mem_bytes":
                  torch.cuda.max_memory_allocated(), "card": card})
        if not static_equal or int_diff or nbe:
            raise AssertionError(f"{name}: the device route's tables are not "
                                 f"equal to the host route's (integer "
                                 f"{int_diff}, float {nbe}, largest "
                                 f"difference {max_diff})")


def phase_kernels_new(device, model, rec, card):
    """prefix.cu and trace.cu against their plain versions on the full
    cell's inputs; returns their rows of the kernels line (launches are
    filled in from the main path)."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine import xputil as U
    from augustus_tpu_torch.engine.viterbi import planes_for, viterbi_forward
    from augustus_tpu_torch.predict import piece_tables

    # ---- prefix.cu on every row the full cell's device route sums ----
    rows, kernel = [], U.prefix_sum_f64

    def capture(x):
        rows.append(x.clone())
        return kernel(x)

    packed, gold, _ = piece_tables(model, rec, None, device, capture)
    err = 0.0
    for x in rows:
        got = kernel(x).cpu()
        plain = U.prefix_sum_f64_reference(x.cpu())
        npsum = np.cumsum(x.cpu().numpy(), axis=-1)
        if not (torch.equal(got.view(torch.int64), plain.view(torch.int64))
                and np.array_equal(got.numpy().view(np.int64),
                                   npsum.view(np.int64))):
            raise AssertionError(f"prefix_sum_f64 differs from its plain "
                                 f"version on a {tuple(x.shape)} input")
        err = max(err, float((got - plain).abs().max()))
    cpu_rows = [x.cpu() for x in rows]
    k_ms = time_cuda(lambda: [kernel(x) for x in rows], 3)
    lib_ms = time_cuda(lambda: [torch.cumsum(x, dim=-1) for x in rows], 3)
    t0 = time.perf_counter()
    for x in cpu_rows:
        U.prefix_sum_f64_reference(x)
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(2 * 8 * x.numel() for x in rows)
    ops = sum(x.numel() for x in rows)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F64_OPS_PER_S * 1e3
    # the same route with torch.cumsum on the card in place of the kernel
    lib_packed, _, _ = piece_tables(model, rec, None, device,
                                    lambda x: torch.cumsum(x, dim=-1))
    _, _, changed, lib_diff = compare_tables(packed, lib_packed)
    prefix_row = {
        "phase": "kernels_new", "kernel": "prefix_sum_f64", "calls": len(rows),
        "rows": sum(int(np.prod(x.shape[:-1])) for x in rows),
        "entries": ops, "parity": "bit-exact (also np.cumsum)",
        "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
        "plain_on": "CPU (torch.cumsum)", "library_ms": lib_ms,
        "bytes": nbytes, "bound_bytes_ms": bound_bytes,
        "bound_ops_ms": bound_ops, "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_changed_f32_entries": sum(changed.values()),
        "library_changed_by_table": changed,
        "library_max_abs_diff": lib_diff, "card": card}
    emit(prefix_row)

    # ---- trace.cu on the full cell's backpointer plane ----------------
    st, arr = packed
    n, S = st.n, st.S
    planes = planes_for(st, arr, device)
    bp, vfin, _ = viterbi_forward(st, planes)
    lt = np.asarray(gold.log_term[:S], dtype=np.float32)
    last = vfin[:S].cpu().numpy() + np.where(np.isfinite(lt), lt,
                                             np.float32(-1.0e30))
    state0 = int(np.argmax(last))
    brk = tb.walk_breaks(bp, n).contiguous()
    ev, res = tb.launch_event_walk(bp, brk, state0, n)
    fb, fs, cnt = (int(v) for v in res.cpu())
    bp_h = bp.cpu()
    brk_h = tb.walk_breaks(bp_h, n)
    if not torch.equal(brk_h, brk.cpu()):
        raise AssertionError("walk_breaks differs between the card and CPU")
    t0 = time.perf_counter()
    ev_p, fb_p, fs_p, cnt_p = tb.event_walk_reference(bp_h, brk_h, state0, n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if (fb, fs, cnt) != (fb_p, fs_p, cnt_p) or \
            not torch.equal(ev.cpu(), ev_p):
        raise AssertionError("event_walk differs from its plain version")
    if cnt >= tb.M_EVENTS or cnt < 100:
        raise AssertionError(f"event walk of {cnt} events on the full cell")
    # past its bound: the walk relaunches from where each launch stopped
    bound = cnt // 3 + 1
    before = tb.event_walk.launches
    ev_b, fb_b, cnt_b = tb.event_walk(bp, state0, n, bound)
    relaunches = tb.event_walk.launches - before
    if (fb_b, cnt_b) != (fb, cnt) or \
            not np.array_equal(ev_b, ev[:cnt].cpu().numpy()) or \
            relaunches != -(-cnt // bound):
        raise AssertionError(f"the event walk with a bound of {bound} "
                             "events differs from one launch")
    k_ms = time_cuda(lambda: tb.launch_event_walk(bp, brk, state0, n), 3)
    brk_ms = time_cuda(lambda: tb.walk_breaks(bp, n), 3)
    t0 = time.perf_counter()
    packed_emits, _ = tb.trace_packed(bp.cpu().numpy(), state0, n)
    host_walk_ms = (time.perf_counter() - t0) * 1e3
    nbytes = cnt * (3 * 4 + 5 * 4) + 12
    trace_row = {
        "phase": "kernels_new", "kernel": "event_walk", "n": n,
        "events": cnt, "final_base": fb, "parity": "exact",
        "bounded_walk": {"bound": bound, "launches": relaunches,
                         "equal": True},
        "max_abs_err": 0, "ms": k_ms, "walk_breaks_ms": brk_ms,
        "plain_ms": plain_ms, "plain_on": "CPU (one step per event)",
        "host_walk_ms": host_walk_ms, "library_ms": None, "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "card": card}
    emit(trace_row)
    return prefix_row, trace_row


def forward_planes(model, rec, n, device):
    """The forward kernel's planes of the first n bases of rec on the route
    of `model` (its heat from --temperature): (static, planes, route)."""
    from augustus_tpu_torch.engine.pack import forward_arrays
    from augustus_tpu_torch.engine.viterbi import planes_for
    from augustus_tpu_torch.predict import piece_tables
    (st, arr), _, route = piece_tables(model, rec, n, device)
    heat = (8.0 - model.cn.temperature) / 8.0
    return st, planes_for(st, forward_arrays(st, arr, heat), device), \
        (st, arr), route


def fwd_gate(st, ref, got, what):
    """Same finite support and |got - ref| <= 4e-3 + 3e-6 * |ref|: (max
    |df|, largest share of the tolerance)."""
    import numpy as np
    r = ref[:, : st.S].cpu().numpy()
    g = got[:, : st.S].cpu().numpy()
    live = r > -5.0e29
    if not np.array_equal(live, g > -5.0e29):
        bad = np.argwhere(live != (g > -5.0e29))
        raise AssertionError(f"{what}: finite support differs at "
                             f"{bad[:5].tolist()} ({len(bad)} entries)")
    err = np.abs(g[live] - r[live])
    share = err / (FWD_ABS_TOL + FWD_REL_TOL * np.abs(r[live]))
    if share.max(initial=0.0) > 1.0:
        raise AssertionError(f"{what}: |df| {err.max()} beyond the "
                             "tolerance")
    return float(err.max(initial=0.0)), float(share.max(initial=0.0))


def phase_forward_parity(device, pieces, card):
    """pieces: (label, model, record, bases or None for all of it), each
    prepared on the host route, as a sampled piece is."""
    import torch
    from augustus_tpu_torch.engine.forward import (
        forward_reference, forward_table, forward_work)
    rows = []
    for label, model, rec, n in pieces:
        st, planes, _, _ = forward_planes(
            dataclasses.replace(model, route="host"), rec, n, device)
        got = forward_table(st, planes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, sfu = forward_reference(st, planes)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1000.0
        err, share = fwd_gate(st, ref, got, f"forward_parity {label}")
        kernel_ms = time_cuda(lambda: forward_table(st, planes), 3)
        parts = forward_work(st, planes)
        nbytes = sum(parts.values())
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_sfu_ms = sfu / SFU_OPS_PER_S * 1e3
        row = {"phase": "forward_parity", "piece": label,
               "species": model.props.get("species"), "record": rec.name,
               "n": st.n, "hints": os.path.basename(
                   model.props.get("hintsfile", "")) or None,
               "NHW": st.NHW, "temperature": model.cn.temperature,
               "support": "identical",
               "tolerance": f"{FWD_ABS_TOL} + {FWD_REL_TOL} * |f|",
               "max_abs_err": err, "max_tolerance_share": share,
               "kernel_ms": kernel_ms, "us_per_position": kernel_ms * 1e3
               / st.n, "plain_ms": plain_ms, "bytes": nbytes,
               "bytes_by_part": parts, "exp_log": sfu,
               "bound_bytes_ms": bound_bytes_ms,
               "bound_sfu_ms": bound_sfu_ms,
               "bound_ms": max(bound_bytes_ms, bound_sfu_ms),
               "bound_by": ("bytes" if bound_bytes_ms >= bound_sfu_ms
                            else "operations"), "card": card}
        emit(row)
        rows.append(row)
    return rows


def phase_full_forward(device, cells, card):
    """The forward kernel on full-size planes, against the Viterbi
    kernel's values of the same planes."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.forward import forward_table
    from augustus_tpu_torch.engine.viterbi import planes_for, viterbi_forward
    for name, model, rec in cells:
        st, fplanes, (_, arr), route = forward_planes(model, rec, None,
                                                      device)
        _, _, v = viterbi_forward(st, planes_for(st, arr, device),
                                  debug_vals=True)
        f = forward_table(st, fplanes)
        torch.cuda.synchronize()
        vv, ff = v[:, : st.S].cpu().numpy(), f[:, : st.S].cpu().numpy()
        live = vv > -5.0e29
        if not np.array_equal(live, ff > -5.0e29):
            raise AssertionError(f"full_forward {name}: the forward table's "
                                 "finite support differs from Viterbi's")
        slack = ff[live] - vv[live]
        tol = FWD_ABS_TOL + FWD_REL_TOL * np.abs(vv[live])
        if (slack < -tol).any():
            raise AssertionError(f"full_forward {name}: f < v - tol at "
                                 f"{int((slack < -tol).sum())} entries")
        ms = time_cuda(lambda: forward_table(st, fplanes), 2)
        emit({"phase": "full_forward", "cell": name, "route": route,
              "n": st.n, "NHW": st.NHW, "live": int(live.sum()),
              "min_f_minus_v": float(slack.min()),
              "max_f_minus_v": float(slack.max()), "kernel_ms": ms,
              "us_per_position": ms * 1e3 / st.n, "card": card})
        del fplanes, f, v


def phase_gff_sample(model_sampled, card):
    """HS04636.fa sampled: cold through the command line, warm in this
    process (a fresh model each, so each starts the rand() stream)."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model
    golden = golden_body("repo_fixture_HS04636_sample100.gff")
    fasta = os.path.join(DATA, "HS04636.fa")
    cmd = [sys.executable, "-m", "augustus_tpu_torch.cli.augustus"] + \
        [f"--{k}={v}" for k, v in model_args("repo_fixture").items()] + \
        [f"--{k}={v}" for k, v in SAMPLE_ARGS.items()] + [fasta]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, check=True, capture_output=True,
                         text=True).stdout
    cold_s = time.perf_counter() - t0
    if strip_comments(out) != golden:
        raise AssertionError("gff_sample cold run (command line): GFF "
                             "differs from the committed golden")
    emit({"phase": "gff_sample", "run": "cold", "via": "command line",
          "equal_to_golden": True, "seconds": cold_s,
          "transcripts": out.count("\ttranscript\t"), "card": card})
    gff, tm, counts, wall, _ = run_predict(model_sampled(),
                                           read_fasta(fasta)[0], "host_prep")
    if strip_comments(gff) != golden:
        raise AssertionError("gff_sample warm run: GFF differs from the "
                             "committed golden")
    emit({"phase": "gff_sample", "run": "warm", "via": "predict_records",
          "equal_to_golden": True, "seconds": wall,
          "transcripts": gff.count("\ttranscript\t"), "counts": counts,
          "stages_s": tm, "card": card})
    hmodel = Model.load(dict(model_args("repo_fixture", "HS04636sm.E.gff"),
                             **SAMPLE_ARGS, **SAMPLE_FILTERS))
    gff, tm, counts, wall, _ = run_predict(
        hmodel, read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0],
        "host_prep")
    if strip_comments(gff) != golden_body(
            "repo_fixture_HS04636sm_hints_sample100.gff") or \
            "# Evidence for and against" not in gff:
        raise AssertionError("gff_sample hinted run: GFF differs from the "
                             "committed golden")
    emit({"phase": "gff_sample", "run": "warm, hints and filters",
          "via": "predict_records", "equal_to_golden": True,
          "seconds": wall, "transcripts": gff.count("\ttranscript\t"),
          "counts": counts, "stages_s": tm, "card": card})


def phase_sample_depth(model, rec, card):
    from augustus_tpu_torch.io.fasta import FastaRecord
    srec = FastaRecord(rec.name, rec.sequence[:SAMPLE_DEPTH])
    gff, tm, counts, wall, peak = run_predict(model, srec, "host_prep")
    if gff.count("\tgene\t") < 1:
        raise AssertionError("sample_depth: no gene predicted")
    mb = SAMPLE_DEPTH / 1e6
    paths = int(SAMPLE_ARGS["sample"]) - 1
    emit({"phase": "sample_depth", "length": SAMPLE_DEPTH,
          "samples": int(SAMPLE_ARGS["sample"]),
          "genes": gff.count("\tgene\t"),
          "transcripts": gff.count("\ttranscript\t"), "wall_s": wall,
          "walk_s": tm.get("sample", 0.0),
          "walk_s_per_mb": tm.get("sample", 0.0) / mb,
          "walk_s_per_sampled_mb": tm.get("sample", 0.0) / (mb * paths),
          "kernel_ms": tm.get("kernel", 0) * 1e3,
          "forward_ms": tm.get("forward", 0) * 1e3,
          "walk_share": tm.get("sample", 0.0) / wall,
          "peak_mem_bytes": peak, "stages_s": tm, "counts": counts,
          "card": card})


def run_predict(model, rec, route):
    """One prediction with stats on: (gff, stage times, counts, wall s,
    peak device bytes); asserts that every piece took `route`."""
    import torch
    from augustus_tpu_torch import stats
    from augustus_tpu_torch.predict import predict_records
    torch.cuda.reset_peak_memory_stats()
    stats.reset(True)
    t0 = time.perf_counter()
    gff = predict_records(model, [rec], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm, counts = dict(stats.TIMES), dict(stats.COUNTS)
    stats.reset(False)
    routes = {k: v for k, v in counts.items() if k.endswith("_prep")}
    if set(routes) != {route}:
        raise AssertionError(f"pieces took the routes {routes}, expected "
                             f"{route}")
    return gff, tm, counts, wall, torch.cuda.max_memory_allocated()


def phase_full(phase, model, rec, golden, card, extra, route,
               labels=("cold", "warm")):
    """Cold and warm predictions of rec on `route`, each held to golden
    (the GFF body) when it is given; returns the rows and the GFF texts."""
    runs, texts = [], []
    for label in labels:
        gff_full, tm, counts, wall, peak = run_predict(model, rec, route)
        if golden is not None and strip_comments(gff_full) != golden:
            raise AssertionError(f"{phase} {label} run: the full-size GFF "
                                 "differs from the committed golden")
        genes = gff_full.count("\tgene\t")
        if genes < 1:
            raise AssertionError(f"{phase}: no gene predicted")
        host_prep = tm.get("prep", 0) + tm.get("build_tracks", 0) + \
            tm.get("pack", 0)
        row = {"phase": phase, "run": label, "route": route,
               "length": len(rec.sequence), "genes": genes,
               "equal_to_golden": golden is not None, **extra,
               "host_prep_s": host_prep,
               "dev_prep_ms": tm.get("dev_prep", 0) * 1e3,
               "expand_ms": tm.get("expand", 0) * 1e3,
               "kernel_ms": tm.get("kernel", 0) * 1e3,
               "traceback_ms": tm.get("traceback", 0) * 1e3,
               "output_s": tm.get("project", 0) + tm.get("print", 0),
               "wall_s": wall, "mb_per_s": len(rec.sequence) / 1e6 / wall,
               "device_stage_share": (tm.get("dev_prep", 0) +
                                      tm.get("expand", 0) +
                                      tm.get("kernel", 0)) / wall,
               "peak_mem_bytes": peak, "stages_s": tm, "counts": counts,
               "card": card}
        emit(row)
        runs.append(row)
        texts.append(gff_full)
    return runs, texts


def predict_phase(phase, model, path, golden_name, route, need_evidence):
    """A cold and a warm prediction of the first record of `path`, each
    byte-equal to the golden (comment lines left out)."""
    from augustus_tpu_torch.io.fasta import read_fasta
    rec = read_fasta(path)[0]
    for label in ("cold", "warm"):
        gff, tm, counts, wall, _ = run_predict(model, rec, route)
        if strip_comments(gff) != golden_body(golden_name):
            raise AssertionError(f"{phase} {label} run: GFF differs from "
                                 "the committed golden")
        ngenes = gff.count("\tgene\t")
        if ngenes < 1 or (need_evidence and
                          "# Evidence for and against" not in gff):
            raise AssertionError(f"{phase}: no gene or no evidence block")
        emit({"phase": phase, "run": label, "route": route, "genes": ngenes,
              "equal_to_golden": True, "seconds": wall, "counts": counts,
              "stages_s": tm})


def kernel_row(name, source, replaces, launches, r, parity):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "parity": parity,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from augustus_tpu_torch.engine import _build
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine import xputil as U
    from augustus_tpu_torch.engine.forward import forward_table
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.io.tiled import tiled_hinted, tiled_record
    from augustus_tpu_torch.predict import Model

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    emit({"phase": "build", "kernels": list(KERNELS),
          "seconds": time.perf_counter() - t0})

    # the chunks of length None (the whole sequence) are the gff and
    # gff_hints phases' inputs
    parity = phase_parity(device, [
        ("repo_fixture", "HS04636.fa", 6000, None),
        ("repo_fixture_gc2", "HS04636.fa", 6000, None),
        ("repo_fixture", "HS04636.fa", None, None),
        ("repo_fixture", "HS04636sm.fa", None, "HS04636sm.E.gff"),
        ("repo_fixture", "HS04636rc.fa", 6000, "HS04636rc.E.gff")])

    model = Model.load(model_args("repo_fixture"))
    gc2 = Model.load(model_args("repo_fixture_gc2"))
    write_exon_free("HS04636sm.E.gff", EXON_FREE_SM)
    sm_model = Model.load(model_args("repo_fixture", EXON_FREE_SM))
    hs04636 = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    hs04636sm = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    rec = tiled_record(DATA)
    phase_prep_parity(device, [
        ("HS04636", model, hs04636, None), ("gc2_6kb", gc2, hs04636, 6000),
        ("HS04636sm_exon_free", sm_model, hs04636sm, None),
        ("full", model, rec, None)], card)
    prefix_row, trace_row = phase_kernels_new(device, model, rec, card)

    def model_sampled(species="repo_fixture", **extra):
        return Model.load(dict(model_args(species), **SAMPLE_ARGS, **extra))

    # the main path's pieces (the first gives the kernels line's row), then
    # a GC-class switch and heated tables
    fwd_parity = phase_forward_parity(device, [
        ("HS04636", model_sampled(), hs04636, None),
        ("HS04636sm_hints", Model.load(dict(
            model_args("repo_fixture", "HS04636sm.E.gff"), **SAMPLE_ARGS,
            **SAMPLE_FILTERS)), hs04636sm, None),
        ("sample_depth", model_sampled(), rec, SAMPLE_DEPTH),
        ("gc2_6kb", model_sampled("repo_fixture_gc2"), hs04636, 6000),
        ("heated_6kb", model_sampled(temperature="3"), hs04636, 6000)],
        card)

    # ---- main path: GFF parity, then full size; counts from here on ----
    viterbi_forward.launches = 0
    viterbi_forward.hinted_launches = 0
    U.prefix_sum_f64.launches = 0
    tb.event_walk.launches = 0
    forward_table.launches = 0
    predict_phase("gff", model, os.path.join(DATA, "HS04636.fa"),
                  "repo_fixture_HS04636.gff", "device_prep", False)
    hmodel = Model.load(model_args("repo_fixture", "HS04636sm.E.gff"))
    predict_phase("gff_hints", hmodel, os.path.join(DATA, "HS04636sm.fa"),
                  "repo_fixture_HS04636sm_hints.gff", "host_prep", True)
    phase_gff_sample(model_sampled, card)

    phase_full("full", model, rec, golden_body("repo_fixture_tiled.gff"),
               card, {}, "device_prep")

    hrec, hint_lines = tiled_hinted(DATA)
    with open(os.path.join(HINTS, "tiled_sm.E.gff")) as fh:
        if fh.read() != "".join(hint_lines):
            raise AssertionError("tiled_sm.E.gff is not tiled_hinted's hints")
    counts = {"rm_runs": len(re.findall("[acgtn]+", hrec.sequence)),
              "softmasked_share": sum(map(str.islower, hrec.sequence))
              / len(hrec.sequence)}
    sm_counts = dict(counts, hints=write_exon_free("tiled_sm.E.gff",
                                                   EXON_FREE))
    sm_dev = Model.load(model_args("repo_fixture", EXON_FREE))
    sm_host = dataclasses.replace(sm_dev, route="host")
    _, dev_texts = phase_full("full_sm", sm_dev, hrec, None, card,
                              sm_counts, "device_prep")
    _, host_texts = phase_full("full_sm", sm_host, hrec, None, card,
                               sm_counts, "host_prep")
    if len(set(dev_texts + host_texts)) != 1:
        raise AssertionError("full_sm: the device and host routes' GFF "
                             "texts differ")
    if "# Evidence for and against" not in dev_texts[0]:
        raise AssertionError("full_sm: no evidence block")
    emit({"phase": "full_sm", "routes_equal": True,
          "genes": dev_texts[0].count("\tgene\t")})

    hmodel = Model.load(model_args("repo_fixture", "tiled_sm.E.gff"))
    phase_full("full_hints", hmodel, hrec, golden_body(
        "repo_fixture_tiled_hints.gff"), card,
        dict(counts, hints=len(hint_lines)), "host_prep")
    phase_sample_depth(model_sampled(), rec, card)
    launches = viterbi_forward.launches
    hinted = viterbi_forward.hinted_launches
    prefix_launches = U.prefix_sum_f64.launches
    walk_launches = tb.event_walk.launches
    fwd_launches = forward_table.launches
    if min(launches, hinted, prefix_launches, walk_launches,
           fwd_launches) < 1:
        raise AssertionError(
            f"the main path launched viterbi_forward {launches} times "
            f"({hinted} with hints), prefix_sum_f64 {prefix_launches}, "
            f"event_walk {walk_launches} and forward_table {fwd_launches} "
            "times")
    phase_full_forward(device, [("full", model, rec),
                                ("full_hints", hmodel, hrec)], card)

    p, ph = parity[2], parity[3]
    vrow = {"max_abs_err": max(r["max_abs_err"] for r in parity),
            "ms": p["kernel_ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None}
    hrow = dict(vrow, max_abs_err=max(r["max_abs_err"] for r in parity[3:]),
                ms=ph["kernel_ms"], plain_ms=ph["plain_ms"],
                bound_ms=ph["bound_ms"], bound_by=ph["bound_by"])
    fp = fwd_parity[0]
    frow = {"max_abs_err": max(r["max_abs_err"] for r in fwd_parity),
            "ms": fp["kernel_ms"], "plain_ms": fp["plain_ms"],
            "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"],
            "library_ms": None}
    emit({"kernels": [
        kernel_row("viterbi_forward", "augustus_tpu_torch/csrc/viterbi.cu",
                   "augustus_tpu/engine/pallas_scan.py:128", launches, vrow,
                   "bit-exact"),
        kernel_row("viterbi_forward:hint_quot",
                   "augustus_tpu_torch/csrc/viterbi.cu",
                   "augustus_tpu/engine/pallas_scan.py:134", hinted, hrow,
                   "bit-exact"),
        kernel_row("prefix_sum_f64", "augustus_tpu_torch/csrc/prefix.cu",
                   "augustus_tpu/engine/xputil.py:188", prefix_launches,
                   prefix_row, "bit-exact"),
        kernel_row("event_walk", "augustus_tpu_torch/csrc/trace.cu",
                   "augustus_tpu/engine/traceback.py:116", walk_launches,
                   trace_row, "exact"),
        kernel_row("forward_table", "augustus_tpu_torch/csrc/forward.cu",
                   "augustus_tpu/engine/scan.py:740", fwd_launches, frow,
                   f"support identical, |df| <= {FWD_ABS_TOL} + "
                   f"{FWD_REL_TOL} * |f|")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
