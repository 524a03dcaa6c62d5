#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (augustus_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernels from the sources in the
checkout, and exits non-zero on any failure (nothing is caught, nothing
falls back to the CPU or to a kernel's plain version).  Phases, one JSON
line each:

  device  card name and power limit (nvidia-smi)
  build   nvcc of csrc/viterbi.cu, prefix.cu, trace.cu, forward.cu,
          scan.cu and scan_lse.cu, and of the measurement builds of
          forward.cu (K3_TWO_PASS: the earlier design; K3_SPLIT: clock64
          stamps), scan.cu (K2_SIMPLE, K2_SPLIT) and scan_lse.cu
          (K5_SIMPLE, K5_SPLIT), all
          started together (set-up time; nvcc's -Xptxas=-v report of registers,
          shared memory and spills goes to stderr)
  parity  the Viterbi kernel on the card against its plain PyTorch version
          on copies of the same planes on the host CPU (an eager loop of
          small operations, faster there than as launches on the card; the
          plain versions of every parity phase run in one spawned process
          per piece, a phase's all at once, those of utr_forward_parity and
          forward_parity while scan_parity, prep_parity and kernels_new
          run), on
          6 kb of tests/data/HS04636.fa with the repo_fixture species,
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
  forward_parity  the forward-table kernel (csrc/forward.cu) on the card
          against its plain PyTorch version on the host CPU (copies of the
          same planes, as in parity), on every piece that the main
          path gives it, built as the sampled runs build them (host route):
          all of HS04636.fa (gff_sample), all of HS04636sm.fa with its EST
          hints (the hinted gff_sample run: sparse hints, the hint quotient)
          and the first SAMPLE_DEPTH bases of the full cell's sequence
          (sample_depth); besides, 6 kb of HS04636.fa with repo_fixture_gc2
          (a GC-class switch) and at --temperature=3 (heated tables): the
          same finite support and |df| <= 4e-3 + 3e-6 * |f| (the sums run in
          another order), and the table bit-equal to the two-pass kernel
          (the K3_TWO_PASS build); max |df| beside the recorded one, kernel,
          two-pass and plain ms, the bound from the bytes of forward_work
          and the exp/log count of the plain version
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
          the host route (Model.route = "host") warm, all three GFF texts
          byte-equal, evidence blocks included, and equal to
          repo_fixture_tiled_sm.gff
  full_hints  the softmasked letters with all the EST hints of every
          inserted gene (host route), one warm run, byte-equal to
          repo_fixture_tiled_hints.gff
  full_forward  the forward kernel on the full cell's planes (device
          route) and on full_hints' (host route): its time and time per
          position, the same finite support as the Viterbi kernel's values
          (debug_vals) and f >= v - (4e-3 + 3e-6 * |v|) everywhere (a
          logsumexp is at least the maximum); then k3_compare on the same
          planes: the table bit-equal to the two-pass kernel, both timed
          in turns (parent, new, new, parent), their registers and stack
          (cuobjdump -res-usage) and, on the full cell, the clock64 split
          of a position for both (the K3_SPLIT builds)
  sample_depth  the sampled prediction of gff_sample on the first
          SAMPLE_DEPTH bases of the full cell's sequence, byte-equal to
          repo_fixture_tiled21k_sample100.gff: seconds of the host walk per
          Mb of sequence and per sampled Mb
  cold    the runs of a process of their own, started together and awaited
          before the warm runs (each takes a CPU core; the card does under
          a second of their work): HS04636.fa sampled (gff_sample) and with
          --mea=1 (gff_mea) through the command line, the GenBank sets
          tests/data/genes_test1.gb and genes_crf3.gb through the command
          line (eval_genbank), and the UTR runs of gff_utr, gff_utr_sample
          and gff_utr_mea, each held to its phase's golden below
  gff_mea HS04636.fa with --mea=1 (100 sampled paths without the
          posterior filters, then the transcripts of the maximum expected
          accuracy path, output/mea.py; host route, the Viterbi and forward
          kernels): cold (above) and warm through predict_records, held to
          repo_fixture_HS04636_mea.gff; HS04636sm.fa with its hints and
          --mea=1 (repo_fixture_HS04636sm_hints_mea.gff) and HS04636.fa with
          --mea=1 --/CompPred/logreg=false (the piecewise-linear scores,
          repo_fixture_HS04636_mea_nologreg.gff), warm: wall s, the walk's
          (sample) and MEA's seconds, transcripts and kernel launches
  mea_depth  --mea=1 on sample_depth's letters, held to
          repo_fixture_tiled21k_mea.gff: wall, walk and MEA s, forward and
          kernel ms, peak device memory
  eval_genbank  the GenBank sets predicted record by record and evaluated
          against their annotation (predict.evaluate_genbank: device route,
          prefix.cu, the Viterbi kernel, the event walk), cold (above) and
          warm, each text held to repo_fixture_eval_test1.out /
          repo_fixture_eval_crf3.out from its first '# ----- sequence
          number' line on without time and command-line lines; every record
          on the device route
  scan_parity  the general Viterbi kernel K2 (csrc/scan.cu) on the card
          against its plain PyTorch version on host copies of the same
          tables, on the pieces of the UTR runs, built as they build them
          (host route, repo_fixture_utr, 71 states): 6 kb of HS04636.fa,
          all of HS04636.fa, all of HS04636sm.fa softmasked with its EST
          hints (the hint quotient) and 6 kb of HS04636rc.fa (reverse-strand
          UTRs); and 6 kb of HS04636.fa with the 47-state repo_fixture,
          where K2's values, backpointers and final column must also equal
          K1's (csrc/viterbi.cu) on the same piece: values, every
          backpointer and the final column bit-equal (tolerance 0); the
          kernel's time and time per position, the widest band, the bound
          from scan_work's bytes and operations
  gff_utr --UTR=on with repo_fixture_utr: HS04636.fa with --print_utr=on,
          HS04636sm.fa softmasked with its hints, and the GenBank set
          tests/data/utrtrain.gb evaluated, each cold (the command line, in
          the cold group) and warm (in this process), held to
          repo_fixture_utr_HS04636.gff, repo_fixture_utr_HS04636sm_hints.gff
          and repo_fixture_utr_eval_utrtrain.out; every piece on the host
          route through K2
  full_utr  the full cell's sequence with --UTR=on --print_utr=on (host
          route, K2, the host walk), byte-equal to
          repo_fixture_utr_tiled.gff: stage times, K2 ms, peak device
          memory, launches, Mb/s
  utr_forward_parity  K5, the logsumexp twin of K2 (csrc/scan_lse.cu), on
          the card against its plain PyTorch version on host copies of the
          same tables (the plain versions run while scan_parity runs), on
          every piece that the sampled UTR runs give it (all of HS04636.fa,
          all of HS04636sm.fa with its hints, utr_sample_depth's piece),
          on 6 kb at --temperature=3 (heated tables) and on 6 kb with the
          47-state repo_fixture, also against K3 (csrc/forward.cu) on the
          same chunk: the same finite support, |df| <= 4e-3 + 3e-6 * |f|,
          two launches bit-identical; time per position, widest band, the
          bound from scan_table_work and the exp/log count
  gff_utr_sample  --UTR=on --print_utr=on --sample=100
          --alternatives-from-sampling=true on HS04636.fa, cold (the cold
          group) and warm, and HS04636sm.fa with its hints and the
          posterior filters, warm, held to repo_fixture_utr_HS04636_
          sample100.gff and repo_fixture_utr_HS04636sm_hints_sample100.gff:
          host route, K2 for the path and K5 for the forward table, the host
          walk; wall, walk share and launches
  gff_utr_mea  HS04636.fa with --UTR=on --print_utr=on --mea=1
          --/CompPred/logreg=false, cold and warm, held to
          repo_fixture_utr_HS04636_mea_nologreg.gff
  utr_sample_depth  sample_depth's letters sampled with --UTR=on, held to
          repo_fixture_utr_tiled21k_sample100.gff: walk seconds per Mb
  full_utr_forward  one timed launch of K5 on full_utr's piece, its
          finite support that of K2's values and f >= v - tol
  k2_compare  K2 against its earlier design (the K2_SIMPLE build of
          csrc/scan.cu) on 6 kb of HS04636.fa with repo_fixture_utr, on the
          same 6 kb with the 47-state repo_fixture and on the first
          K2_COMPARE_DEPTH bases of full_utr's piece:
          values, backpointers and final column bit-equal; both timed in
          turns (simple, new, new, simple); registers, spills and shared
          memory of the four builds (cuobjdump -res-usage); the clock64
          split of a position for both (the K2_SPLIT builds): cycles of each
          phase and barrier wait by warp role, which role reaches each
          barrier last, band entries and segments per warp
  k5_compare  on the same tables of the same three pieces, K5 against its
          earlier design (the K5_SIMPLE build of csrc/scan_lse.cu): the same
          finite support and |df| <= 4e-3 + 3e-6 * |f| (the new design sums
          in another order), the largest |df| and its share of the
          tolerance; both timed in turns (simple, new, new, simple);
          registers, spills and shared memory of the four builds; the
          clock64 split of a position for both (the K5_SPLIT builds): each
          phase and barrier wait by warp role, the role and the warp that
          reach each barrier last, phase A's runs and merges of parked
          pairs and phase B's segment values and variant folds per warp
Every prediction phase prints the route of each piece (stats counts) and
asserts the one it expects; the new phases print the kernels' launches.
Then the seconds of each group of phases, the kernels line, the card line
and the final status line.  The golden comparisons leave out comment
lines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
SPLIT = ("K3_SPLIT",)       # forward.cu's cycle-stamping build
TWO_PASS = ("K3_TWO_PASS",)  # forward.cu's earlier two-pass design
K2_SPLIT = ("K2_SPLIT",)     # scan.cu's cycle-stamping build
K2_SIMPLE = ("K2_SIMPLE",)   # scan.cu's earlier design, a warp per state
K5_SPLIT = ("K5_SPLIT",)     # scan_lse.cu's cycle-stamping build
K5_SIMPLE = ("K5_SIMPLE",)   # scan_lse.cu's earlier design, serial merges
# the libraries: each kernel, and forward.cu's, scan.cu's and
# scan_lse.cu's measurement builds
KERNELS = ("viterbi", "prefix", "trace", "forward", "scan", "scan_lse",
           ("forward", TWO_PASS), ("forward", SPLIT),
           ("forward", SPLIT + TWO_PASS), ("scan", K2_SIMPLE),
           ("scan", K2_SPLIT), ("scan", K2_SPLIT + K2_SIMPLE),
           ("scan_lse", K5_SIMPLE), ("scan_lse", K5_SPLIT),
           ("scan_lse", K5_SPLIT + K5_SIMPLE))
# forward_parity's largest |df| per piece as PERF.md recorded it for the
# two-pass design before the redesign (H100 80GB HBM3, 700 W)
RECORDED_MAX_DF = {"HS04636": 9.77e-4, "HS04636sm_hints": 9.77e-4,
              "sample_depth": 1.95e-3}
FWD_ABS_TOL, FWD_REL_TOL = 4e-3, 3e-6
SAMPLE_ARGS = {"sample": "100", "alternatives-from-sampling": "true"}
# the posterior filters of the hinted sampled golden
SAMPLE_FILTERS = {"minexonintronprob": "0.08", "minmeanexonintronprob": "0.4",
                  "keep_viterbi": "true"}
SAMPLE_DEPTH = 21_000     # bases of the full cell's sequence sampled
# bases of full_utr's piece that k2_compare and k5_compare take
K2_COMPARE_DEPTH = 100_000
MEA_ARGS = {"mea": "1"}
NOLOGREG = {"/CompPred/logreg": "false"}
# the GenBank sets of eval_genbank and their goldens
EVAL_SETS = {"genes_test1.gb": "repo_fixture_eval_test1.out",
             "genes_crf3.gb": "repo_fixture_eval_crf3.out"}
UTR_PRINT = {"print_utr": "on"}
UTR_EVAL = ("utrtrain.gb", "repo_fixture_utr_eval_utrtrain.out")
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
    """The species' arguments (--UTR=on for a species named *_utr); with a
    hints file (a name in data/hints or a path), softmasking on and the EST
    hints with extrinsic.M.RM.E.W.cfg."""
    utr = "on" if species.endswith("_utr") else "off"
    if hints is None:
        return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
                "UTR": utr, "softmasking": "0"}
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": utr, "softmasking": "1",
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


def on_cpu(planes: dict) -> dict:
    """Host copies of a chunk's planes, the plain versions' inputs."""
    import torch
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in planes.items()}


def _plain(job):
    """One plain version on the host CPU, in a process of its own: (its
    result, its ms)."""
    import torch
    torch.set_num_threads(1)
    kind, args = job
    if kind == "viterbi":
        from augustus_tpu_torch.engine.viterbi import \
            viterbi_forward_reference as fn
    elif kind == "forward":
        from augustus_tpu_torch.engine.forward import forward_reference as fn
    elif kind == "scan_table":
        from augustus_tpu_torch.engine.scan import scan_table_reference as fn
    else:
        from augustus_tpu_torch.engine.scan import \
            scan_forward_reference as fn
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1000.0


def plain_start(jobs):
    """Start the plain versions of a phase's pieces, one spawned process
    each (single-threaded loops of small torch operations; the card's host
    has 8 cores); plain_results awaits them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(min(len(jobs), os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context(
                                   "spawn"))
    return pool, [pool.submit(_plain, job) for job in jobs]


def plain_results(started) -> list:
    """[(result, ms)] of plain_start's jobs, in their order."""
    pool, futures = started
    try:
        return [f.result() for f in futures]
    finally:
        pool.shutdown()


def plain_versions(jobs) -> list:
    """The plain versions of a phase's pieces, all at once."""
    return plain_results(plain_start(jobs))


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
    from augustus_tpu_torch.engine.viterbi import kernel_work, viterbi_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_planes
    rows, pieces = [], []
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
        pieces.append((species, fasta, n, hints, st, planes, switches,
                       (bp_k, vf_k, v_k)))
    plain = plain_versions([("viterbi", (st, on_cpu(planes), True))
                            for (*_, st, planes, _, _) in pieces])
    for (species, fasta, n, hints, st, planes, switches,
         (bp_k, vf_k, v_k)), ((bp_p, vf_p, v_p), plain_ms) in zip(pieces,
                                                                 plain):
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
               "plain_ms": plain_ms, "plain_on": "CPU, one process per "
               "chunk at once", "bytes": nbytes,
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


def forward_parity_start(device, pieces):
    """forward_parity's first half: K3 on each piece (label, model, record,
    bases or None for all of it), prepared on the host route as a sampled
    piece is, bit-equal to the two-pass build; its plain versions started
    on the host CPU (they run while the next phases run)."""
    import torch
    from augustus_tpu_torch.engine.forward import forward_table
    done = []
    for label, model, rec, n in pieces:
        st, planes, _, _ = forward_planes(
            dataclasses.replace(model, route="host"), rec, n, device)
        got = forward_table(st, planes)
        two = forward_table(st, planes, TWO_PASS)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), two.view(torch.int32)):
            bad = (got.view(torch.int32) != two.view(torch.int32)).sum()
            raise AssertionError(f"forward_parity {label}: {int(bad)} entries "
                                 "differ from the two-pass kernel")
        done.append((label, model, rec, st, planes, got))
    return done, plain_start([("forward", (st, on_cpu(planes)))
                              for (_, _, _, st, planes, _) in done])


def forward_parity_finish(started, card):
    """forward_parity's second half: each piece against its plain version
    (the same finite support, |df| <= 4e-3 + 3e-6 * |f|), times and bound."""
    from augustus_tpu_torch.engine.forward import forward_table, forward_work
    done, plain = started
    rows = []
    for (label, model, rec, st, planes, got), ((ref, sfu), plain_ms) in zip(
            done, plain_results(plain)):
        err, share = fwd_gate(st, ref, got, f"forward_parity {label}")
        kernel_ms = time_cuda(lambda: forward_table(st, planes), 3)
        two_ms = time_cuda(lambda: forward_table(st, planes, TWO_PASS), 3)
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
               "max_abs_err": err, "recorded_max_abs_err":
               RECORDED_MAX_DF.get(label),
               "max_tolerance_share": share,
               "bit_equal_to_two_pass": True, "kernel_ms": kernel_ms,
               "two_pass_ms": two_ms, "us_per_position": kernel_ms * 1e3
               / st.n, "plain_ms": plain_ms,
               "plain_on": "CPU, one process per piece at once",
               "bytes": nbytes,
               "bytes_by_part": parts, "exp_log": sfu,
               "bound_bytes_ms": bound_bytes_ms,
               "bound_sfu_ms": bound_sfu_ms,
               "bound_ms": max(bound_bytes_ms, bound_sfu_ms),
               "bound_by": ("bytes" if bound_bytes_ms >= bound_sfu_ms
                            else "operations"), "card": card}
        emit(row)
        rows.append(row)
    return rows


def fetch_split(name, build, prefix, slots):
    """The clock64 split of the last launch of csrc/<name>.cu built with
    `build`: {slot: per-warp cycles (float64)}, read through its
    <prefix>_split_warps / _slots / _fetch functions."""
    import ctypes
    import numpy as np
    from augustus_tpu_torch.engine import _build
    lib = _build.load(name, build)
    nw = getattr(lib, f"{prefix}_split_warps")()
    ns = getattr(lib, f"{prefix}_split_slots")()
    if ns != len(slots):
        raise AssertionError(f"{name}.cu has {ns} split slots")
    buf = np.zeros((nw, ns), np.uint64)
    err = getattr(lib, f"{prefix}_split_fetch")(
        ctypes.c_void_p(buf.ctypes.data))
    if err:
        raise RuntimeError(f"{prefix}_split_fetch: CUDA error {err}")
    return {k: buf[:, i].astype(np.float64) for i, k in enumerate(slots)}


SPLIT_SLOTS = ("stage", "bar1", "work", "bar2", "lane", "entries",
               "max_entries", "over_kept", "gated", "last1", "last2", "gap2",
               "loop")


def k3_split(st, planes, defines=()):
    """One launch of forward.cu's K3_SPLIT build (with `defines`): per
    position, the cycles of each part of the loop by warp role (the items a
    warp takes in phase A; the chain states in phase B, except in the
    K3_TWO_PASS layout; the thread items on the last two warps; the lane
    update on warps 0-1), the share of positions in which each role reached
    each barrier last and its lead at the second, and the clipped entries
    per gated position of each warp that takes one conv only."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.forward import forward_table
    build = SPLIT + tuple(defines)
    forward_table(st, planes, build)
    torch.cuda.synchronize()
    c = fetch_split("forward", build, "forward", SPLIT_SLOTS)
    nw = len(c["loop"])
    pos = st.n - 1
    two_pass = TWO_PASS[0] in defines
    n_groups = -(-len(st.chain_states) // 32)
    kinds = ["conv"] * len(st.convs) + ["lessd"] * len(st.lessd) + \
        ["chain"] * (n_groups if two_pass else 0)
    item_warps = nw - 2

    def role(w):
        if w >= item_warps:
            return "thread_items"
        r = "+".join(sorted({kinds[i] for i in range(w, len(kinds),
                                                     item_warps)})) or "idle"
        if not two_pass and item_warps - 1 - w < n_groups:
            r += ", chain in phase B"
        return r
    roles = {}
    for w in range(nw):
        roles.setdefault(role(w), []).append(w)
    out = {"warps": nw, "positions": pos,
           "cycles_per_position": float(c["loop"].max() / pos),
           "roles": roles}
    for r, ws in roles.items():
        out[r] = {k: {"mean": float(c[k][ws].mean() / pos),
                      "max": float(c[k][ws].max() / pos)}
                  for k in ("stage", "bar1", "work", "bar2")}
    for b in ("last1", "last2"):
        out[f"{b}_share_by_role"] = {
            r: float(c[b][ws].sum() / pos) for r, ws in roles.items()
            if c[b][ws].sum()}
    out["gap2_per_position_by_role"] = {
        r: float(c["gap2"][ws].sum() / pos) for r, ws in roles.items()
        if c["gap2"][ws].sum()}
    conv = roles.get("conv", [])          # warps that take one conv only
    out["conv_warps"] = conv
    gated = np.maximum(c["gated"][conv], 1)
    out["conv_gated_share"] = [round(float(x / pos), 4)
                               for x in c["gated"][conv]]
    out["conv_entries_per_gated_position"] = [
        round(float(x), 1) for x in c["entries"][conv] / gated]
    out["conv_max_entries"] = [int(x) for x in c["max_entries"][conv]]
    # the share of gated positions with entries beyond the 32 K3_R kept
    out["conv_share_beyond_kept"] = [
        round(float(x), 4) for x in c["over_kept"][conv] / gated]
    out["lane_update"] = float(c["lane"][:2].max() / pos)
    return out


def res_usage(defines=(), name="forward",
              kernel="forward_table_kernel") -> str:
    """Registers, stack (spills) and static shared memory of a kernel built
    with `defines` (cuobjdump -res-usage; nvcc's -Xptxas=-v says the same
    on stderr at the build)."""
    from augustus_tpu_torch.engine import _build
    cuobj = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobj, "-res-usage",
                          _build._lib_path(name, defines)],
                         check=True, capture_output=True, text=True).stdout
    m = re.search(kernel + r"\S*:\s*\n\s*(REG:\d+ STACK:\d+ SHARED:\d+)",
                  out)
    return m.group(1) if m else out


def segment_role(st, w):
    """What warp w does in phases 2 and 3 of the segment design that K2 and
    K5 share (csrc/k2_common.cuh): phase 2 four conv / lessD states a warp
    on warps 0-10 (FP_WARP), the fixed and pinned states on warp 11, the
    next position's segments on warps 12-15 (SEG_WARP); phase 3 eight lanes
    / chain states a warp."""
    ncomb = len(st.convs) + len(st.lessd)
    nred = st.NL + len(st.chain)
    b = ("combine" if w < 11 and 4 * w < ncomb else
         "fixed+pinned" if w == 11 else
         "next segments" if w >= 12 else "idle")
    r = "lanes+chain" if 8 * w < nred else "idle"
    return f"2: {b}, 3: {r}"


def barrier_roles(c, npos, roles):
    """From a three-barrier split (K2's or K5's slots w1 .. bar3, last1 ..
    last3): per role each warp's work and wait per position at each
    barrier (mean and max over the role's warps), and the share of
    positions in which each role arrived last."""
    out = {r: {k: {"mean": float(c[k][ws].mean() / npos),
                   "max": float(c[k][ws].max() / npos)}
               for k in ("w1", "bar1", "w2", "bar2", "w3", "bar3")}
           for r, ws in roles.items()}
    for b in ("last1", "last2", "last3"):
        out[f"{b}_share_by_role"] = {
            r: float(c[b][ws].sum() / npos) for r, ws in roles.items()
            if c[b][ws].sum()}
    return out


K2_SLOTS = ("w1", "bar1", "w2", "bar2", "w3", "bar3", "entries", "segs",
            "max_entries", "band", "loads", "red", "last1", "last2",
            "last3", "ph1", "ph2", "ph3", "npos")
# what phases 1-3 of a position hold in each design (csrc/scan.cu)
K2_PHASES = {"simple": ("tasks", "bp row and lane update", "vprev copy"),
             "new": ("row staging and band shares",
                     "conv and lessD states, fixed and pinned states, next "
                     "segments",
                     "lanes and next chain states")}


def k2_split(st, t, v0, defines=()):
    """One launch of scan.cu's K2_SPLIT build (with `defines`): per
    position, each phase from barrier release to barrier release, and by
    warp role (in the earlier design the kinds of task a warp holds; in the new
    one what it does in phases 2 and 3) each warp's work from the previous
    release to its arrival and its wait until the release, the share of
    positions in which each role arrived last, and the band entries,
    segment pieces and cycles in band walks of each warp."""
    import torch
    from augustus_tpu_torch.engine.scan import scan_forward
    build = K2_SPLIT + tuple(defines)
    scan_forward(st, t, v0, defines=build)
    torch.cuda.synchronize()
    c = fetch_split("scan", build, "k2", K2_SLOTS)
    nw = len(c["npos"])
    npos = max(c["npos"][0], 1.0)     # positions with all three phases
    pos = st.n - 1
    simple = K2_SIMPLE[0] in defines
    if simple:
        kinds = ["conv"] * len(st.convs) + ["lessd"] * len(st.lessd) + \
            ["chain"] * len(st.chain) + ["fixed"] * len(st.fixed) + \
            ["pinned"] * len(st.pinned)

        def role(w):
            return "+".join(sorted({kinds[i] for i in range(w, len(kinds),
                                                         nw)})) or "idle"
    else:
        # phase 1 bands on every warp; phases 2 and 3 as segment_role says
        def role(w):
            return segment_role(st, w)
    roles = {}
    for w in range(nw):
        roles.setdefault(role(w), []).append(w)
    phases = K2_PHASES["simple" if simple else "new"]
    out = {"design": "simple" if simple else "new", "warps": nw,
           "positions": int(npos),
           "cycles_per_position": float(
               (c["ph1"][0] + c["ph2"][0] + c["ph3"][0]) / npos),
           "phase_cycles": {ph: float(c[k][0] / npos) for ph, k in
                            zip(phases, ("ph1", "ph2", "ph3"))},
           "roles": roles}
    out.update(barrier_roles(c, npos, roles))
    for k in ("band", "loads", "red"):
        out[f"{k}_cycles_per_position_by_warp"] = [
            round(float(x / pos)) for x in c[k]]
    out["entries_per_position_by_warp"] = [
        round(float(x / pos), 1) for x in c["entries"]]
    out["max_entries_by_warp"] = [int(x) for x in c["max_entries"]]
    out["segs_per_position_by_warp"] = [
        round(float(x / pos), 2) for x in c["segs"]]
    return out


def k2_compare_row(name, st, t, v0, usage, card):
    """scan.cu's design against its earlier one (the K2_SIMPLE build) on
    the same tables: values, backpointers and final column bit-equal; timed
    in turns (simple, new, new, simple); registers, spills and shared
    memory of the four builds (`usage`); the clock64 split of both (the
    K2_SPLIT builds)."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.scan import scan_forward
    new = scan_forward(st, t, v0, debug_vals=True)
    old = scan_forward(st, t, v0, debug_vals=True, defines=K2_SIMPLE)
    torch.cuda.synchronize()
    if not (torch.equal(new[0], old[0]) and
            torch.equal(new[1].view(torch.int32),
                        old[1].view(torch.int32)) and
            torch.equal(new[2].view(torch.int32),
                        old[2].view(torch.int32))):
        raise AssertionError(f"k2_compare {name}: the new design and "
                             "K2_SIMPLE differ")
    del new, old
    turns = {K2_SIMPLE: [], (): []}
    for d in (K2_SIMPLE, (), (), K2_SIMPLE):
        turns[d].append(time_cuda(
            lambda: scan_forward(st, t, v0, defines=d), 1))
    simple, new_ms = (float(np.mean(turns[d])) for d in (K2_SIMPLE, ()))
    row = {"phase": "k2_compare", "piece": name, "n": st.n, "S": st.S,
           "NHW": st.NHW, "bit_equal_to_simple": True,
           "simple_ms": turns[K2_SIMPLE], "new_ms": turns[()],
           "simple_us_per_position": simple * 1e3 / st.n,
           "new_us_per_position": new_ms * 1e3 / st.n,
           "speedup": simple / new_ms, "res_usage": usage,
           "split_simple": k2_split(st, t, v0, K2_SIMPLE),
           "split_new": k2_split(st, t, v0), "card": card}
    emit(row)
    return row


K5_SLOTS = ("w1", "bar1", "w2", "bar2", "w3", "bar3", "entries", "pieces",
            "max_entries", "runs", "merge", "bseg", "bfold", "last1",
            "last2", "last3", "ph1", "ph2", "ph3", "min1", "min2", "min3",
            "npos")
K5_PHASES = ("A: row staging, the band shares' runs and merges",
             "B: conv and lessD states, fixed and pinned states (and the "
             "previous row, new design), next segments",
             "C: lanes and next chain states")


def k5_split(st, t, v0, defines=()):
    """One launch of scan_lse.cu's K5_SPLIT build (with `defines`): per
    position, each phase from barrier release to barrier release; by warp
    role (segment_role) each warp's work from the previous release to its
    arrival and its wait until the release, and the share of positions in
    which each role and each warp arrived last; per warp phase A's runs
    and merges of the parked pairs, phase B's segment values and variant
    folds (warps 0-10), band entries and segment pieces."""
    import torch
    from augustus_tpu_torch.engine.scan import scan_table
    build = K5_SPLIT + tuple(defines)
    scan_table(st, t, v0, defines=build)
    torch.cuda.synchronize()
    c = fetch_split("scan_lse", build, "k5", K5_SLOTS)
    nw = len(c["npos"])
    npos = max(c["npos"][0], 1.0)     # positions with all three phases
    pos = st.n - 1
    roles = {}
    for w in range(nw):
        roles.setdefault(segment_role(st, w), []).append(w)
    out = {"design": "simple" if K5_SIMPLE[0] in defines else "new",
           "warps": nw, "positions": int(npos),
           "cycles_per_position": float(
               (c["ph1"][0] + c["ph2"][0] + c["ph3"][0]) / npos),
           "phase_cycles": {ph: float(c[k][0] / npos) for ph, k in
                            zip(K5_PHASES, ("ph1", "ph2", "ph3"))},
           # the position with the least work in each phase: the chain
           # that every position waits for
           "min_phase_cycles": {ph: int(c[k][0]) for ph, k in
                                zip(K5_PHASES, ("min1", "min2", "min3"))},
           "roles": roles}
    out.update(barrier_roles(c, npos, roles))
    for b in ("last1", "last2", "last3"):
        out[f"{b}_share_by_warp"] = [round(float(x / npos), 4)
                                     for x in c[b]]
    for k in ("runs", "merge", "bseg", "bfold"):
        out[f"{k}_cycles_per_position_by_warp"] = [
            round(float(x / pos)) for x in c[k]]
    out["entries_per_position_by_warp"] = [
        round(float(x / pos), 1) for x in c["entries"]]
    out["max_entries_by_warp"] = [int(x) for x in c["max_entries"]]
    out["pieces_per_position_by_warp"] = [
        round(float(x / pos), 2) for x in c["pieces"]]
    return out


def k5_compare_row(name, st, t, v0, usage, card):
    """scan_lse.cu's design against its earlier one (the K5_SIMPLE build)
    on the same tables: the same finite support and |df| <= 4e-3 + 3e-6 * |f|
    (the sums run in another order), the largest |df| and its share; both
    timed in turns (simple, new, new, simple); registers, spills and shared
    memory of the four builds (`usage`); the clock64 split of both (the
    K5_SPLIT builds)."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.scan import scan_table
    new = scan_table(st, t, v0)
    old = scan_table(st, t, v0, defines=K5_SIMPLE)
    torch.cuda.synchronize()
    err, share = fwd_gate(st, old, new, f"k5_compare {name}")
    same_bits = bool(torch.equal(new.view(torch.int32),
                                 old.view(torch.int32)))
    del new, old
    turns = {K5_SIMPLE: [], (): []}
    for d in (K5_SIMPLE, (), (), K5_SIMPLE):
        turns[d].append(time_cuda(
            lambda: scan_table(st, t, v0, defines=d), 1))
    simple, new_ms = (float(np.mean(turns[d])) for d in (K5_SIMPLE, ()))
    row = {"phase": "k5_compare", "piece": name, "n": st.n, "S": st.S,
           "NHW": st.NHW, "support": "identical",
           "tolerance": f"{FWD_ABS_TOL} + {FWD_REL_TOL} * |f|",
           "max_abs_df_vs_simple": err, "max_tolerance_share": share,
           "bit_equal_to_simple": same_bits,
           "simple_ms": turns[K5_SIMPLE], "new_ms": turns[()],
           "simple_us_per_position": simple * 1e3 / st.n,
           "new_us_per_position": new_ms * 1e3 / st.n,
           "speedup": simple / new_ms, "res_usage": usage,
           "split_simple": k5_split(st, t, v0, K5_SIMPLE),
           "split_new": k5_split(st, t, v0), "card": card}
    emit(row)
    return row


def build_usage(name, kernel, simple, split):
    """res_usage of a source's four builds: the design, its earlier one,
    and the split builds of both."""
    return {"new": res_usage((), name, kernel),
            "simple": res_usage(simple, name, kernel),
            "new_split": res_usage(split, name, kernel),
            "simple_split": res_usage(split + simple, name, kernel)}


def phase_band_compare(device, pieces, card):
    """k2_compare and k5_compare on the same tables of each piece (name,
    model, record, bases): K2 against its K2_SIMPLE build, then K5 against
    its K5_SIMPLE build."""
    import torch
    from augustus_tpu_torch.predict import piece_scan
    usage2 = build_usage("scan", "scan_forward_kernel", K2_SIMPLE, K2_SPLIT)
    usage5 = build_usage("scan_lse", "scan_table_kernel", K5_SIMPLE,
                         K5_SPLIT)
    rows = []
    for name, model, rec, n in pieces:
        st, t, v0, _ = piece_scan(model, rec, n, device)
        rows.append(k2_compare_row(name, st, t, v0, usage2, card))
        rows.append(k5_compare_row(name, st, t, v0, usage5, card))
        del t
        torch.cuda.empty_cache()
    return rows


def phase_full_forward(device, cells, card):
    """The forward kernel on full-size planes, against the Viterbi
    kernel's values of the same planes; then k3_compare: against the
    two-pass kernel (the K3_TWO_PASS build) on the same planes, bit for
    bit and in time, in turns (parent, new, new, parent), and on the full
    cell the clock64 split of both (the K3_SPLIT builds)."""
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
        del v
        two = forward_table(st, fplanes, TWO_PASS)
        if not torch.equal(f.view(torch.int32), two.view(torch.int32)):
            raise AssertionError(f"k3_compare {name}: the table differs from "
                                 "two-pass kernel")
        del f, two
        turns = {TWO_PASS: [], (): []}
        for d in (TWO_PASS, (), (), TWO_PASS):
            turns[d].append(time_cuda(lambda: forward_table(st, fplanes, d),
                                      1))
        parent, new = (float(np.mean(turns[d])) for d in (TWO_PASS, ()))
        row = {"phase": "k3_compare", "cell": name, "n": st.n,
               "NHW": st.NHW, "bit_equal_to_parent": True,
               "parent_ms": turns[TWO_PASS], "new_ms": turns[()],
               "parent_us_per_position": parent * 1e3 / st.n,
               "new_us_per_position": new * 1e3 / st.n,
               "speedup": parent / new,
               "res_usage": {"new": res_usage(),
                             "parent": res_usage(TWO_PASS)}, "card": card}
        if name == "full":
            row["split_parent"] = k3_split(st, fplanes, TWO_PASS)
            row["split_new"] = k3_split(st, fplanes)
        emit(row)
        del fplanes


def phase_gff_sample(model_sampled, cold, card):
    """HS04636.fa sampled: cold through the command line (the cold phase),
    warm in this process (a fresh model each, so each starts the rand()
    stream)."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model
    golden = golden_body("repo_fixture_HS04636_sample100.gff")
    fasta = os.path.join(DATA, "HS04636.fa")
    out, cold_s = cold["gff_sample"]
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


def phase_sample_depth(model, rec, card, phase="sample_depth",
                       golden="repo_fixture_tiled21k_sample100.gff"):
    from augustus_tpu_torch.io.fasta import FastaRecord
    srec = FastaRecord(rec.name, rec.sequence[:SAMPLE_DEPTH])
    before = launch_counts()
    gff, tm, counts, wall, peak = run_predict(model, srec, "host_prep")
    if strip_comments(gff) != golden_body(golden):
        raise AssertionError(f"{phase}: GFF differs from the committed "
                             "golden")
    mb = SAMPLE_DEPTH / 1e6
    paths = int(SAMPLE_ARGS["sample"]) - 1
    emit({"phase": phase, "length": SAMPLE_DEPTH,
          "samples": int(SAMPLE_ARGS["sample"]), "equal_to_golden": True,
          "genes": gff.count("\tgene\t"),
          "transcripts": gff.count("\ttranscript\t"), "wall_s": wall,
          "walk_s": tm.get("sample", 0.0),
          "walk_s_per_mb": tm.get("sample", 0.0) / mb,
          "walk_s_per_sampled_mb": tm.get("sample", 0.0) / (mb * paths),
          "kernel_ms": tm.get("kernel", 0) * 1e3,
          "forward_ms": tm.get("forward", 0) * 1e3,
          "walk_share": tm.get("sample", 0.0) / wall,
          "launches": launches_since(before), "peak_mem_bytes": peak,
          "stages_s": tm, "counts": counts, "card": card})


def eval_filter(text: str) -> list:
    """The lines of an evaluation text that its goldens compare: from the
    first '# ----- sequence number' line on, without time and command-line
    lines (the filter of tests/test_evaluation.py)."""
    lines = text.split("\n")
    start = next(i for i, l in enumerate(lines)
                 if "# ----- sequence number" in l)
    return [l for l in lines[start:]
            if "# total time:" not in l and "command line" not in l]


def cli_args(args: dict) -> list:
    return [sys.executable, "-m", "augustus_tpu_torch.cli.augustus"] + \
        [f"--{k}={v}" for k, v in args.items()]


def phase_cold(card):
    """Start the command-line runs together, each a process of its own, and
    await them: {name: (stdout, seconds)}; each must exit 0."""
    species = {k: v for k, v in model_args("repo_fixture").items()
               if k != "softmasking"}     # GenBank input sets it off
    hs04636 = os.path.join(DATA, "HS04636.fa")
    cmds = {"gff_sample": cli_args(dict(model_args("repo_fixture"),
                                        **SAMPLE_ARGS)) + [hs04636],
            "gff_mea": cli_args(dict(model_args("repo_fixture"),
                                     **MEA_ARGS)) + [hs04636]}
    for gb in EVAL_SETS:
        cmds[gb] = cli_args(species) + [os.path.join(DATA, gb)]
    utr = dict(model_args("repo_fixture_utr"), **UTR_PRINT)
    cmds["gff_utr"] = cli_args(utr) + [hs04636]
    cmds["gff_utr_hints"] = cli_args(model_args(
        "repo_fixture_utr", "HS04636sm.E.gff")) + [
        os.path.join(DATA, "HS04636sm.fa")]
    cmds[UTR_EVAL[0]] = cli_args({k: v for k, v in utr.items()
                                  if k != "softmasking"}) + [
        os.path.join(DATA, UTR_EVAL[0])]
    cmds["gff_utr_sample"] = cli_args(dict(utr, **SAMPLE_ARGS)) + [hs04636]
    cmds["gff_utr_mea"] = cli_args(dict(utr, **MEA_ARGS, **NOLOGREG)) + [
        hs04636]

    def run(cmd):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        return r, time.perf_counter() - t0
    with ThreadPoolExecutor(len(cmds)) as pool:
        done = dict(zip(cmds, pool.map(run, cmds.values())))
    out = {}
    for k, (r, seconds) in done.items():
        if r.returncode:
            raise AssertionError(f"cold run {k} exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        out[k] = (r.stdout, seconds)
    emit({"phase": "cold", "runs": list(cmds), "seconds":
          {k: v[1] for k, v in out.items()}, "card": card})
    return out


def launch_counts() -> dict:
    from augustus_tpu_torch.engine import traceback as tb
    from augustus_tpu_torch.engine import xputil as U
    from augustus_tpu_torch.engine.forward import forward_table
    from augustus_tpu_torch.engine.scan import scan_forward, scan_table
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    return {"viterbi_forward": viterbi_forward.launches,
            "viterbi_forward:hint_quot": viterbi_forward.hinted_launches,
            "prefix_sum_f64": U.prefix_sum_f64.launches,
            "event_walk": tb.event_walk.launches,
            "forward_table": forward_table.launches,
            "scan_forward": scan_forward.launches,
            "scan_table": scan_table.launches}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def mea_row(phase, run, gff, tm, counts, wall, launches, card):
    return {"phase": phase, "run": run, "equal_to_golden": True,
            "genes": gff.count("\tgene\t"),
            "transcripts": gff.count("\ttranscript\t"), "wall_s": wall,
            "walk_s": tm.get("sample", 0.0), "mea_s": tm.get("mea", 0.0),
            "forward_ms": tm.get("forward", 0.0) * 1e3,
            "kernel_ms": tm.get("kernel", 0.0) * 1e3, "launches": launches,
            "counts": counts, "stages_s": tm, "card": card}


def phase_gff_mea(model_sampled, cold, card):
    """HS04636.fa with --mea=1 cold (the command line) and warm, HS04636sm.fa
    hinted and HS04636.fa with the piecewise-linear scores warm, each held
    to its golden; a fresh model each (a fresh rand() stream)."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model
    golden = golden_body("repo_fixture_HS04636_mea.gff")
    out, cold_s = cold["gff_mea"]
    if strip_comments(out) != golden:
        raise AssertionError("gff_mea cold run (command line): GFF differs "
                             "from the committed golden")
    emit({"phase": "gff_mea", "run": "cold", "via": "command line",
          "equal_to_golden": True, "seconds": cold_s,
          "transcripts": out.count("\ttranscript\t"), "card": card})
    hs04636 = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    hs04636sm = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    runs = [("warm", model_sampled(**MEA_ARGS), hs04636,
             "repo_fixture_HS04636_mea.gff"),
            ("warm, hints", Model.load(dict(
                model_args("repo_fixture", "HS04636sm.E.gff"), **MEA_ARGS)),
             hs04636sm, "repo_fixture_HS04636sm_hints_mea.gff"),
            ("warm, logreg off", model_sampled(**MEA_ARGS, **NOLOGREG),
             hs04636, "repo_fixture_HS04636_mea_nologreg.gff")]
    for label, model, rec, name in runs:
        before = launch_counts()
        gff, tm, counts, wall, _ = run_predict(model, rec, "host_prep")
        if strip_comments(gff) != golden_body(name):
            raise AssertionError(f"gff_mea {label} run: GFF differs from "
                                 f"the committed golden {name}")
        if "hints" in label and "# Evidence for and against" not in gff:
            raise AssertionError("gff_mea hinted run: no evidence block")
        emit(mea_row("gff_mea", label, gff, tm, counts, wall,
                     launches_since(before), card))


def phase_mea_depth(model, rec, card):
    from augustus_tpu_torch.io.fasta import FastaRecord
    srec = FastaRecord(rec.name, rec.sequence[:SAMPLE_DEPTH])
    before = launch_counts()
    gff, tm, counts, wall, peak = run_predict(model, srec, "host_prep")
    if strip_comments(gff) != golden_body("repo_fixture_tiled21k_mea.gff"):
        raise AssertionError("mea_depth: GFF differs from the committed "
                             "golden")
    emit(dict(mea_row("mea_depth", "warm", gff, tm, counts, wall,
                      launches_since(before), card),
              length=SAMPLE_DEPTH, peak_mem_bytes=peak))


def phase_eval_genbank(model, cold, card):
    """Both GenBank sets evaluated cold (the command line) and warm
    (evaluate_genbank), each text held to its golden, every record on the
    device route."""
    from augustus_tpu_torch.io.genbank import read_genbank
    from augustus_tpu_torch.predict import evaluate_genbank
    for gb, golden_name in EVAL_SETS.items():
        with open(os.path.join(GOLDEN_DIR, golden_name)) as fh:
            golden = eval_filter(fh.read())
        out, cold_s = cold[gb]
        if eval_filter(out.split("# command line:\n")[0]) != golden:
            raise AssertionError(f"eval_genbank cold run (command line) of "
                                 f"{gb}: text differs from {golden_name}")
        emit({"phase": "eval_genbank", "set": gb, "run": "cold",
              "via": "command line", "equal_to_golden": True,
              "seconds": cold_s, "card": card})
        path = os.path.join(DATA, gb)
        records = read_genbank(path)
        before = launch_counts()
        text, tm, counts, wall, _ = measured(
            lambda: evaluate_genbank(model, path, device="cuda"))
        if eval_filter(text) != golden:
            raise AssertionError(f"eval_genbank warm run of {gb}: text "
                                 f"differs from {golden_name}")
        routes = routes_of(counts)
        if routes != {"device_prep": len(records)}:
            raise AssertionError(f"eval_genbank {gb}: the records took the "
                                 f"routes {routes}")
        emit({"phase": "eval_genbank", "set": gb, "run": "warm",
              "via": "evaluate_genbank", "equal_to_golden": True,
              "records": len(records),
              "bases": sum(a.length for a in records),
              "annotated_genes": sum(len(a.genes) for a in records),
              "predicted_genes": text.count("\tgene\t"), "wall_s": wall,
              "launches": launches_since(before), "counts": counts,
              "stages_s": tm, "card": card})


def phase_scan_parity(device, pieces, card):
    """K2 on the card against its plain version on host copies of the same
    tables (bit-equal everywhere); a 47-state piece also against K1."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.scan import scan_forward, scan_work
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.predict import piece_planes, piece_scan
    rows, done = [], []
    for name, model, rec, n in pieces:
        st, t, v0, gold = piece_scan(model, rec, n, device)
        got = scan_forward(st, t, v0, debug_vals=True)
        torch.cuda.synchronize()
        done.append((name, model, rec, n, st, t, v0, got))
    plain = plain_versions([("scan", (st, on_cpu(t), v0.cpu(), True))
                            for (*_, st, t, v0, _) in done])
    for (name, model, rec, n, st, t, v0, (bp_k, vf_k, v_k)), (
            (bp_p, vf_p, v_p), plain_ms) in zip(done, plain):
        host = on_cpu(t)
        vk, vp = v_k.cpu().numpy(), v_p.numpy()
        if not np.array_equal(vk.view(np.int32), vp.view(np.int32)):
            bad = np.argwhere(vk.view(np.int32) != vp.view(np.int32))
            raise AssertionError(f"scan_parity {name}: values differ at "
                                 f"{bad[:5].tolist()} ({len(bad)} entries)")
        if not np.array_equal(bp_k.cpu().numpy(), bp_p.numpy()):
            bad = np.argwhere(bp_k.cpu().numpy() != bp_p.numpy())
            raise AssertionError(f"scan_parity {name}: backpointers differ "
                                 f"at {bad[:5].tolist()}")
        if not torch.equal(vf_k.cpu(), vf_p):
            raise AssertionError(f"scan_parity {name}: final column differs")
        live = vp[1:] > -5.0e29
        row = {"phase": "scan_parity", "piece": name, "n": st.n, "S": st.S,
               "NL": st.NL, "NHW": st.NHW, "GPAD": st.GPAD,
               "widest_band": max(v.width for c in st.convs
                                  for v in c.variants),
               "parity": "bit-exact", "tolerance": 0.0,
               "max_abs_err": float(np.abs(vk[1:][live] - vp[1:][live]).max()
                                    if live.any() else 0.0),
               "live_values": int(live.sum())}
        if st.S <= 64:
            st1, planes, _ = piece_planes(model, rec, n, device)
            bp1, vf1, v1 = viterbi_forward(st1, planes, debug_vals=True)
            S = st.S
            v1 = v1[:, :S].cpu().numpy()
            live1 = v1[1:] > -5.0e29
            if not (np.array_equal(v1[1:].view(np.int32),
                                   vk[1:].view(np.int32))
                    and ((bp1[1:, :S].cpu().numpy() == bp_k[1:].cpu().numpy())
                         | ~live1).all()
                    and torch.equal(vf1[:S].cpu(), vf_k.cpu())):
                raise AssertionError(f"scan_parity {name}: K2 and K1 "
                                     "differ on a 47-state piece")
            row["equal_to_k1"] = True
        kernel_ms = time_cuda(lambda: scan_forward(st, t, v0), 3)
        parts, ops_by_part = scan_work(st, {k: v.numpy()
                                            for k, v in host.items()})
        nbytes, ops = sum(parts.values()), sum(ops_by_part.values())
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_OPS_PER_S * 1e3
        row.update({
            "kernel_ms": kernel_ms, "us_per_position": kernel_ms * 1e3 / st.n,
            "plain_ms": plain_ms,
            "plain_on": "CPU, one process per piece at once", "bytes": nbytes,
            "bytes_by_part": parts, "ops": ops, "ops_by_part": ops_by_part,
            "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"), "card": card})
        emit(row)
        rows.append(row)
    return rows


def phase_gff_utr(cold, card):
    """--UTR=on runs, cold (the command line) and warm, each held to its
    golden; every piece on the host route through K2."""
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, evaluate_genbank
    runs = [("gff_utr", Model.load(dict(model_args("repo_fixture_utr"),
                                        **UTR_PRINT)),
             "HS04636.fa", "repo_fixture_utr_HS04636.gff"),
            ("gff_utr_hints", Model.load(model_args(
                "repo_fixture_utr", "HS04636sm.E.gff")),
             "HS04636sm.fa", "repo_fixture_utr_HS04636sm_hints.gff")]
    for key, model, fasta, golden_name in runs:
        golden = golden_body(golden_name)
        out, cold_s = cold[key]
        if strip_comments(out) != golden:
            raise AssertionError(f"{key} cold run (command line): GFF "
                                 f"differs from {golden_name}")
        emit({"phase": "gff_utr", "input": fasta, "run": "cold",
              "via": "command line", "equal_to_golden": True,
              "seconds": cold_s, "card": card})
        rec = read_fasta(os.path.join(DATA, fasta))[0]
        before = launch_counts()
        gff, tm, counts, wall, peak = run_predict(model, rec, "host_prep")
        if strip_comments(gff) != golden:
            raise AssertionError(f"{key} warm run: GFF differs from "
                                 f"{golden_name}")
        for line in ("\ttss\t", "\ttts\t"):
            if line not in gff:
                raise AssertionError(f"{key}: no {line.strip()} line")
        emit({"phase": "gff_utr", "input": fasta, "run": "warm",
              "equal_to_golden": True, "genes": gff.count("\tgene\t"),
              "wall_s": wall, "kernel_ms": tm.get("kernel", 0) * 1e3,
              "launches": launches_since(before), "counts": counts,
              "stages_s": tm, "peak_mem_bytes": peak, "card": card})
    gb, golden_name = UTR_EVAL
    with open(os.path.join(GOLDEN_DIR, golden_name)) as fh:
        golden = eval_filter(fh.read())
    out, cold_s = cold[gb]
    if eval_filter(out.split("# command line:\n")[0]) != golden:
        raise AssertionError(f"gff_utr cold run (command line) of {gb}: "
                             f"text differs from {golden_name}")
    emit({"phase": "gff_utr", "input": gb, "run": "cold",
          "via": "command line", "equal_to_golden": True, "seconds": cold_s,
          "card": card})
    model = Model.load(dict(model_args("repo_fixture_utr"), **UTR_PRINT))
    path = os.path.join(DATA, gb)
    before = launch_counts()
    text, tm, counts, wall, _ = measured(
        lambda: evaluate_genbank(model, path, device="cuda"))
    if eval_filter(text) != golden:
        raise AssertionError(f"gff_utr warm run of {gb}: text differs from "
                             f"{golden_name}")
    if set(routes_of(counts)) != {"host_prep"}:
        raise AssertionError(f"gff_utr {gb}: routes {routes_of(counts)}")
    emit({"phase": "gff_utr", "input": gb, "run": "warm",
          "via": "evaluate_genbank", "equal_to_golden": True,
          "wall_s": wall, "launches": launches_since(before),
          "counts": counts, "stages_s": tm, "card": card})


def phase_full_utr(rec, card):
    """The full cell's sequence with --UTR=on --print_utr=on, held to
    repo_fixture_utr_tiled.gff."""
    from augustus_tpu_torch.predict import Model
    model = Model.load(dict(model_args("repo_fixture_utr"), **UTR_PRINT))
    before = launch_counts()
    runs, texts = phase_full("full_utr", model, rec,
                             golden_body("repo_fixture_utr_tiled.gff"),
                             card, {}, "host_prep", labels=("warm",))
    text = strip_comments(texts[0])
    emit({"phase": "full_utr", "launches": launches_since(before),
          "tss": text.count("\ttss\t"), "tts": text.count("\ttts\t"),
          "k2_ms": runs[0]["kernel_ms"],
          "k2_us_per_position": runs[0]["kernel_ms"] * 1e3 / len(
              rec.sequence)})


def utr_forward_tables(model, rec, n, device):
    """K5's inputs for the first n bases of rec as a sampled UTR piece
    builds them (host route, the split tables of its ScanEngine heated by
    --temperature): (static, tables on the card, v0 on the card, host
    copies of the tables, v0 on the host)."""
    from augustus_tpu_torch.engine.scan import heated, scan_tensors
    from augustus_tpu_torch.predict import piece_scan
    st, t, v0, _ = piece_scan(model, rec, n, "cpu")
    arrays = heated(st, {k: v.numpy() for k, v in t.items()},
                    (8.0 - model.cn.temperature) / 8.0)
    return st, scan_tensors(arrays, device), v0.to(device), \
        scan_tensors(arrays, "cpu"), v0


def utr_forward_start(device, pieces):
    """utr_forward_parity's first half: K5 (csrc/scan_lse.cu) twice on each
    piece, bit-identical, and its plain versions started on the host CPU
    (they run while scan_parity runs)."""
    import torch
    from augustus_tpu_torch.engine.scan import scan_table
    done = []
    for label, model, rec, n in pieces:
        st, t, v0, host, hv0 = utr_forward_tables(model, rec, n, device)
        got = scan_table(st, t, v0)
        again = scan_table(st, t, v0)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            bad = int((got.view(torch.int32) != again.view(torch.int32))
                      .sum())
            raise AssertionError(f"utr_forward_parity {label}: two launches "
                                 f"differ in {bad} entries")
        done.append((label, model, rec, n, st, t, v0, got,
                     ("scan_table", (st, host, hv0))))
    return done, plain_start([job for *_, job in done])


def utr_forward_finish(device, started, card):
    """utr_forward_parity's second half: each piece against its plain
    version (the same finite support, |df| <= 4e-3 + 3e-6 * |f|), a
    47-state piece also against K3 (csrc/forward.cu) on the same chunk; the
    kernel's time beside its bound (bytes and operations of
    scan_table_work, the plain version's exp/log count)."""
    from augustus_tpu_torch.engine.forward import forward_table
    from augustus_tpu_torch.engine.scan import scan_table, scan_table_work
    done, plain = started
    rows = []
    for (label, model, rec, n, st, t, v0, got, (_, (_, host, _))), (
            (ref, sfu), plain_ms) in zip(done, plain_results(plain)):
        err, share = fwd_gate(st, ref, got, f"utr_forward_parity {label}")
        row = {"phase": "utr_forward_parity", "piece": label,
               "species": model.props.get("species"), "record": rec.name,
               "n": st.n, "S": st.S, "NL": st.NL, "NHW": st.NHW,
               "temperature": model.cn.temperature,
               "widest_band": max(v.width for c in st.convs
                                  for v in c.variants),
               "support": "identical",
               "tolerance": f"{FWD_ABS_TOL} + {FWD_REL_TOL} * |f|",
               "max_abs_err": err, "max_tolerance_share": share,
               "two_launches_bit_identical": True}
        if st.S <= 64:
            st3, fplanes, _, _ = forward_planes(
                dataclasses.replace(model, route="host"), rec, n, device)
            k3_err, k3_share = fwd_gate(st, forward_table(st3, fplanes),
                                        got, f"utr_forward_parity {label} "
                                        "against K3")
            row.update(k3_max_abs_err=k3_err, k3_tolerance_share=k3_share)
        kernel_ms = time_cuda(lambda: scan_table(st, t, v0), 3)
        parts, ops_by_part = scan_table_work(
            st, {k: v.numpy() for k, v in host.items()})
        nbytes, ops = sum(parts.values()), sum(ops_by_part.values())
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": max(ops / F32_OPS_PER_S,
                                   sfu / SFU_OPS_PER_S) * 1e3}
        row.update({
            "kernel_ms": kernel_ms, "us_per_position": kernel_ms * 1e3 / st.n,
            "plain_ms": plain_ms,
            "plain_on": "CPU, one process per piece at once", "bytes": nbytes,
            "bytes_by_part": parts, "ops": ops, "ops_by_part": ops_by_part,
            "exp_log": sfu, "bound_bytes_ms": bound["bytes"],
            "bound_ops_ms": ops / F32_OPS_PER_S * 1e3,
            "bound_sfu_ms": sfu / SFU_OPS_PER_S * 1e3,
            "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get), "card": card})
        emit(row)
        rows.append(row)
    return rows


def phase_gff_utr_sample(cold, card):
    """--UTR=on sampled: HS04636.fa cold (the command line) and warm,
    HS04636sm.fa with its hints and the posterior filters warm, each held
    to its golden; every piece on the host route through K2 and K5."""
    from augustus_tpu_torch.predict import Model
    runs = [("warm", Model.load(dict(model_args("repo_fixture_utr"),
                                     **UTR_PRINT, **SAMPLE_ARGS)),
             "HS04636.fa", "repo_fixture_utr_HS04636_sample100.gff"),
            ("warm, hints and filters", Model.load(dict(
                model_args("repo_fixture_utr", "HS04636sm.E.gff"),
                **SAMPLE_ARGS, **SAMPLE_FILTERS)),
             "HS04636sm.fa", "repo_fixture_utr_HS04636sm_hints_sample100.gff")]
    utr_gff_runs("gff_utr_sample", cold, runs, card)


def phase_gff_utr_mea(cold, card):
    """--UTR=on with --mea=1 --/CompPred/logreg=false on HS04636.fa, cold
    and warm, held to its golden."""
    from augustus_tpu_torch.predict import Model
    utr_gff_runs("gff_utr_mea", cold, [
        ("warm", Model.load(dict(model_args("repo_fixture_utr"), **UTR_PRINT,
                                 **MEA_ARGS, **NOLOGREG)),
         "HS04636.fa", "repo_fixture_utr_HS04636_mea_nologreg.gff")], card)


def utr_gff_runs(phase, cold, runs, card):
    """The cold run of `phase` (the command line, the first run's golden),
    then each warm run, held to its golden: host route, K2 and K5 launched
    once per piece."""
    from augustus_tpu_torch.io.fasta import read_fasta
    out, cold_s = cold[phase]
    if strip_comments(out) != golden_body(runs[0][3]):
        raise AssertionError(f"{phase} cold run (command line): GFF differs "
                             f"from {runs[0][3]}")
    emit({"phase": phase, "input": runs[0][2], "run": "cold",
          "via": "command line", "equal_to_golden": True, "seconds": cold_s,
          "transcripts": out.count("\ttranscript\t"), "card": card})
    for label, model, fasta, golden_name in runs:
        rec = read_fasta(os.path.join(DATA, fasta))[0]
        before = launch_counts()
        gff, tm, counts, wall, peak = run_predict(model, rec, "host_prep")
        if strip_comments(gff) != golden_body(golden_name):
            raise AssertionError(f"{phase} {label} run: GFF differs from "
                                 f"{golden_name}")
        launches = launches_since(before)
        if launches["scan_forward"] < 1 or launches["scan_table"] < 1:
            raise AssertionError(f"{phase} {label}: launches {launches}")
        emit(dict(mea_row(phase, label, gff, tm, counts, wall, launches,
                          card), input=fasta, peak_mem_bytes=peak,
                  walk_share=tm.get("sample", 0.0) / wall))


def phase_full_utr_forward(device, model, rec, card):
    """K5 on full_utr's piece: one timed launch; the same finite support as
    K2's values of the piece and f >= v - (4e-3 + 3e-6 * |v|) everywhere
    (a logsumexp is at least the maximum)."""
    import numpy as np
    import torch
    from augustus_tpu_torch.engine.scan import scan_forward, scan_table
    from augustus_tpu_torch.predict import piece_scan
    st, t, v0, _ = piece_scan(model, rec, None, device)
    v = scan_forward(st, t, v0, debug_vals=True)[2].cpu().numpy()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    f = scan_table(st, t, v0)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    f = f.cpu().numpy()
    live = v > -5.0e29
    if not np.array_equal(live, f > -5.0e29):
        raise AssertionError("full_utr_forward: the forward table's finite "
                             "support differs from K2's")
    slack = f[live] - v[live]
    if (slack < -(FWD_ABS_TOL + FWD_REL_TOL * np.abs(v[live]))).any():
        raise AssertionError("full_utr_forward: f < v - tol")
    emit({"phase": "full_utr_forward", "n": st.n, "NHW": st.NHW,
          "live": int(live.sum()), "min_f_minus_v": float(slack.min()),
          "max_f_minus_v": float(slack.max()), "kernel_ms": ms,
          "us_per_position": ms * 1e3 / st.n, "card": card})


def measured(fn):
    """fn() with stats on: (its result, stage times, counts, wall s, peak
    device bytes)."""
    import torch
    from augustus_tpu_torch import stats
    torch.cuda.reset_peak_memory_stats()
    stats.reset(True)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm, counts = dict(stats.TIMES), dict(stats.COUNTS)
    stats.reset(False)
    return out, tm, counts, wall, torch.cuda.max_memory_allocated()


def routes_of(counts: dict) -> dict:
    """{route: pieces} of a run's stats counts."""
    return {k: v for k, v in counts.items() if k.endswith("_prep")}


def run_predict(model, rec, route):
    """One prediction with stats on: (gff, stage times, counts, wall s,
    peak device bytes); asserts that every piece took `route`."""
    from augustus_tpu_torch.predict import predict_records
    got = measured(lambda: predict_records(model, [rec], device="cuda"))
    routes = routes_of(got[2])
    if set(routes) != {route}:
        raise AssertionError(f"pieces took the routes {routes}, expected "
                             f"{route}")
    return got


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
    from augustus_tpu_torch.engine.scan import scan_forward, scan_table
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.io.tiled import tiled_hinted, tiled_record
    from augustus_tpu_torch.predict import Model

    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name):
        """Seconds since the previous lap, under `name`."""
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for spec in KERNELS:
        _build.load(*((spec,) if isinstance(spec, str) else spec))
    emit({"phase": "build", "kernels": [
        spec if isinstance(spec, str) else " ".join([spec[0]] + list(spec[1]))
        for spec in KERNELS],
          "seconds": time.perf_counter() - t0})
    lap("device, build")

    # the chunks of length None (the whole sequence) are the gff and
    # gff_hints phases' inputs
    parity = phase_parity(device, [
        ("repo_fixture", "HS04636.fa", 6000, None),
        ("repo_fixture_gc2", "HS04636.fa", 6000, None),
        ("repo_fixture", "HS04636.fa", None, None),
        ("repo_fixture", "HS04636sm.fa", None, "HS04636sm.E.gff"),
        ("repo_fixture", "HS04636rc.fa", 6000, "HS04636rc.E.gff")])
    lap("parity")

    model = Model.load(model_args("repo_fixture"))
    gc2 = Model.load(model_args("repo_fixture_gc2"))
    utr = Model.load(dict(model_args("repo_fixture_utr"), **UTR_PRINT))
    hs04636 = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    hs04636sm = read_fasta(os.path.join(DATA, "HS04636sm.fa"))[0]
    hs04636rc = read_fasta(os.path.join(DATA, "HS04636rc.fa"))[0]
    rec = tiled_record(DATA)

    def model_sampled(species="repo_fixture", **extra):
        return Model.load(dict(model_args(species), **SAMPLE_ARGS, **extra))

    def utr_sampled(**extra):
        return model_sampled("repo_fixture_utr", **UTR_PRINT, **extra)

    # K5 on the sampled UTR runs' pieces (the first gives the kernels
    # line's row), heated tables, and a 47-state piece (also against K3);
    # its plain versions run on the host while scan_parity runs
    utr_fwd = utr_forward_start(device, [
        ("HS04636", utr_sampled(), hs04636, None),
        ("HS04636sm_hints", Model.load(dict(
            model_args("repo_fixture_utr", "HS04636sm.E.gff"), **SAMPLE_ARGS,
            **SAMPLE_FILTERS)), hs04636sm, None),
        ("utr_sample_depth", utr_sampled(), rec, SAMPLE_DEPTH),
        ("heated_6kb", utr_sampled(temperature="3"), hs04636, 6000),
        ("47_state_6kb", model_sampled(), hs04636, 6000)])
    # the UTR runs' pieces (the first gives the kernels line's row), then
    # K2 against K1 on the 47-state architecture
    scan_rows = phase_scan_parity(device, [
        ("HS04636_6kb", utr, hs04636, 6000), ("HS04636", utr, hs04636, None),
        ("HS04636sm_hints", Model.load(model_args(
            "repo_fixture_utr", "HS04636sm.E.gff")), hs04636sm, None),
        ("HS04636rc_6kb", utr, hs04636rc, 6000),
        ("47_state_6kb", model, hs04636, 6000)], card)
    lap("scan_parity")
    # K3 on the main path's sampled pieces (the first gives the kernels
    # line's row), then a GC-class switch and heated tables; its plain
    # versions run on the host with K5's while the next phases run
    fwd = forward_parity_start(device, [
        ("HS04636", model_sampled(), hs04636, None),
        ("HS04636sm_hints", Model.load(dict(
            model_args("repo_fixture", "HS04636sm.E.gff"), **SAMPLE_ARGS,
            **SAMPLE_FILTERS)), hs04636sm, None),
        ("sample_depth", model_sampled(), rec, SAMPLE_DEPTH),
        ("gc2_6kb", model_sampled("repo_fixture_gc2"), hs04636, 6000),
        ("heated_6kb", model_sampled(temperature="3"), hs04636, 6000)])
    write_exon_free("HS04636sm.E.gff", EXON_FREE_SM)
    sm_model = Model.load(model_args("repo_fixture", EXON_FREE_SM))
    phase_prep_parity(device, [
        ("HS04636", model, hs04636, None), ("gc2_6kb", gc2, hs04636, 6000),
        ("HS04636sm_exon_free", sm_model, hs04636sm, None),
        ("full", model, rec, None)], card)
    prefix_row, trace_row = phase_kernels_new(device, model, rec, card)
    lap("prep_parity, kernels_new")
    utr_fwd_rows = utr_forward_finish(device, utr_fwd, card)
    fwd_parity = forward_parity_finish(fwd, card)
    lap("utr_forward_parity, forward_parity")

    cold = phase_cold(card)
    lap("cold")

    # ---- main path: GFF parity, then full size; counts from here on ----
    viterbi_forward.launches = 0
    viterbi_forward.hinted_launches = 0
    U.prefix_sum_f64.launches = 0
    tb.event_walk.launches = 0
    forward_table.launches = 0
    scan_forward.launches = 0
    scan_table.launches = 0
    predict_phase("gff", model, os.path.join(DATA, "HS04636.fa"),
                  "repo_fixture_HS04636.gff", "device_prep", False)
    hmodel = Model.load(model_args("repo_fixture", "HS04636sm.E.gff"))
    predict_phase("gff_hints", hmodel, os.path.join(DATA, "HS04636sm.fa"),
                  "repo_fixture_HS04636sm_hints.gff", "host_prep", True)
    phase_gff_sample(model_sampled, cold, card)
    phase_gff_mea(model_sampled, cold, card)
    phase_eval_genbank(model, cold, card)
    phase_gff_utr(cold, card)
    lap("gff .. gff_utr")
    phase_gff_utr_sample(cold, card)
    phase_gff_utr_mea(cold, card)
    lap("gff_utr_sample, gff_utr_mea")

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
    sm_golden = golden_body("repo_fixture_tiled_sm.gff")
    _, dev_texts = phase_full("full_sm", sm_dev, hrec, sm_golden, card,
                              sm_counts, "device_prep")
    _, host_texts = phase_full("full_sm", sm_host, hrec, sm_golden, card,
                               sm_counts, "host_prep", labels=("warm",))
    if len(set(dev_texts + host_texts)) != 1:
        raise AssertionError("full_sm: the device and host routes' GFF "
                             "texts differ")
    if "# Evidence for and against" not in dev_texts[0]:
        raise AssertionError("full_sm: no evidence block")
    emit({"phase": "full_sm", "routes_equal": True,
          "equal_to_golden": True,
          "genes": dev_texts[0].count("\tgene\t")})

    hmodel = Model.load(model_args("repo_fixture", "tiled_sm.E.gff"))
    phase_full("full_hints", hmodel, hrec, golden_body(
        "repo_fixture_tiled_hints.gff"), card,
        dict(counts, hints=len(hint_lines)), "host_prep", labels=("warm",))
    lap("full, full_sm, full_hints")
    phase_full_utr(rec, card)
    lap("full_utr")
    phase_sample_depth(model_sampled(), rec, card)
    phase_mea_depth(model_sampled(**MEA_ARGS), rec, card)
    lap("sample_depth, mea_depth")
    phase_sample_depth(utr_sampled(), rec, card, "utr_sample_depth",
                       "repo_fixture_utr_tiled21k_sample100.gff")
    lap("utr_sample_depth")
    launches = launch_counts()
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path's kernel launches: {launches}")
    phase_full_forward(device, [("full", model, rec),
                                ("full_hints", hmodel, hrec)], card)
    lap("full_forward, k3_compare")
    phase_full_utr_forward(device, utr, rec, card)
    lap("full_utr_forward")
    phase_band_compare(device, [("HS04636_6kb", utr, hs04636, 6000),
                                ("47_state_6kb", model, hs04636, 6000),
                                ("full_utr_100kb", utr, rec,
                                 K2_COMPARE_DEPTH)], card)
    lap("k2_compare, k5_compare")
    emit({"phase": "seconds", "by_phase": laps,
          "total": time.perf_counter() - t_start})

    p, ph = parity[2], parity[3]
    vrow = {"max_abs_err": max(r["max_abs_err"] for r in parity),
            "ms": p["kernel_ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None}
    hrow = dict(vrow, max_abs_err=max(r["max_abs_err"] for r in parity[3:]),
                ms=ph["kernel_ms"], plain_ms=ph["plain_ms"],
                bound_ms=ph["bound_ms"], bound_by=ph["bound_by"])
    sp = scan_rows[0]
    srow = {"max_abs_err": max(r["max_abs_err"] for r in scan_rows),
            "ms": sp["kernel_ms"], "plain_ms": sp["plain_ms"],
            "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"],
            "library_ms": None}
    fp = fwd_parity[0]
    frow = {"max_abs_err": max(r["max_abs_err"] for r in fwd_parity),
            "ms": fp["kernel_ms"], "plain_ms": fp["plain_ms"],
            "bound_ms": fp["bound_ms"], "bound_by": fp["bound_by"],
            "library_ms": None}
    up = utr_fwd_rows[0]
    lrow = {"max_abs_err": max(r["max_abs_err"] for r in utr_fwd_rows),
            "ms": up["kernel_ms"], "plain_ms": up["plain_ms"],
            "bound_ms": up["bound_ms"], "bound_by": up["bound_by"],
            "library_ms": None}
    emit({"kernels": [
        kernel_row("viterbi_forward", "augustus_tpu_torch/csrc/viterbi.cu",
                   "augustus_tpu/engine/pallas_scan.py:128",
                   launches["viterbi_forward"], vrow,
                   "bit-exact"),
        kernel_row("viterbi_forward:hint_quot",
                   "augustus_tpu_torch/csrc/viterbi.cu",
                   "augustus_tpu/engine/pallas_scan.py:134",
                   launches["viterbi_forward:hint_quot"], hrow,
                   "bit-exact"),
        kernel_row("prefix_sum_f64", "augustus_tpu_torch/csrc/prefix.cu",
                   "augustus_tpu/engine/xputil.py:188",
                   launches["prefix_sum_f64"],
                   prefix_row, "bit-exact"),
        kernel_row("event_walk", "augustus_tpu_torch/csrc/trace.cu",
                   "augustus_tpu/engine/traceback.py:116",
                   launches["event_walk"],
                   trace_row, "exact"),
        kernel_row("forward_table", "augustus_tpu_torch/csrc/forward.cu",
                   "augustus_tpu/engine/scan.py:740",
                   launches["forward_table"], frow,
                   f"support identical, |df| <= {FWD_ABS_TOL} + "
                   f"{FWD_REL_TOL} * |f|"),
        kernel_row("scan_forward", "augustus_tpu_torch/csrc/scan.cu",
                   "augustus_tpu/engine/scan.py:502",
                   launches["scan_forward"], srow, "bit-exact"),
        kernel_row("scan_table", "augustus_tpu_torch/csrc/scan_lse.cu",
                   "augustus_tpu/engine/scan.py:740",
                   launches["scan_table"], lrow,
                   f"support identical, |df| <= {FWD_ABS_TOL} + "
                   f"{FWD_REL_TOL} * |f|")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
