#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (augustus_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernel from the sources in the checkout,
and exits non-zero on any failure (nothing is caught, nothing falls back to
the CPU or to a kernel's plain version).  Phases, one JSON line each:

  device  card name and power limit (nvidia-smi)
  build   nvcc of csrc/viterbi.cu (set-up time)
  parity  the Viterbi kernel against its plain PyTorch version on the card,
          on 6 kb of tests/data/HS04636.fa with the repo_fixture species,
          with the two-GC-class species repo_fixture_gc2 (a class switch
          inside the chunk), and on all of HS04636.fa, the chunk that the
          gff phase gives the kernel: per-step values bit-equal (tolerance
          0), live backpointers equal, final column equal; the kernel's
          time beside its roofline bound, with the bytes per position
  gff     predict_file(..., device="cuda") on HS04636.fa, byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_HS04636.gff
  full    ab-initio prediction on the 1,023,095-base sequence of
          augustus_tpu_torch/io/tiled.py: one cold run, then one warm run
          with the per-stage breakdown, each byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_tiled.gff
Then the kernels line, the card line and the final status line.  The GFF
comparisons leave out comment lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
GOLDEN_DIR = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden")
DATA = os.path.join(ROOT, "tests", "data")

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def model_args(species: str) -> dict:
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "0"}


def golden_body(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return strip_comments(fh.read())


def strip_comments(text: str) -> str:
    return "".join(l for l in text.splitlines(True) if not l.startswith("#"))


def chunk_planes(species: str, seq: str, device):
    from augustus_tpu_torch import genetics
    from augustus_tpu_torch.predict import Model
    from augustus_tpu_torch.engine.gold import GoldEngine
    from augustus_tpu_torch.engine.device import build_tracks
    from augustus_tpu_torch.engine.pack import pack_tracks
    from augustus_tpu_torch.engine.viterbi import planes_for
    m = Model.load(model_args(species))
    codes = genetics.encode(seq.lower())
    gold = GoldEngine(m.sg, m.cn, m.igp, m.exp, m.inp, m.decomp, m.gcode)
    gold.prepare(codes)
    st, arr = pack_tracks(build_tracks(gold))
    switches = int((gold.stairs[1:] != gold.stairs[:-1]).sum())
    return st, planes_for(st, arr, device), switches


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
    seq = read_fasta(os.path.join(DATA, "HS04636.fa"))[0].sequence
    rows = []
    for species, n in chunks:
        st, planes, switches = chunk_planes(species, seq[:n], device)
        n = st.n
        if species.endswith("gc2") and switches < 1:
            raise AssertionError("the gc2 chunk has no GC-class switch")
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
        parts, ops = kernel_work(st, planes)
        nbytes = sum(parts.values())
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_OPS_PER_S * 1e3
        row = {"phase": "parity", "species": species, "n": n,
               "gc_switches": switches, "parity": "bit-exact",
               "tolerance": 0.0,
               "max_abs_err": float(np.abs(vk[live] - vp[live]).max()
                                    if live.any() else 0.0),
               "live_values": int(live.sum()), "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "bytes": nbytes,
               "bytes_per_position": nbytes / n, "bytes_by_part": parts,
               "ops": ops, "bound_bytes_ms": bound_bytes_ms,
               "bound_ops_ms": bound_ops_ms,
               "bound_ms": max(bound_bytes_ms, bound_ops_ms),
               "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                            else "operations")}
        emit(row)
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from augustus_tpu_torch import stats
    from augustus_tpu_torch.engine import _build
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.tiled import tiled_record
    from augustus_tpu_torch.predict import Model, predict_file, \
        predict_records

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.load("viterbi")
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    # the last chunk (None: all of HS04636.fa) is the gff phase's input
    parity = phase_parity(device, [("repo_fixture", 6000),
                                   ("repo_fixture_gc2", 6000),
                                   ("repo_fixture", None)])

    # ---- main path: GFF parity, then full size; counts from here on ----
    viterbi_forward.launches = 0
    model = Model.load(model_args("repo_fixture"))
    t0 = time.perf_counter()
    gff = predict_file(model, os.path.join(DATA, "HS04636.fa"),
                       device="cuda")
    if strip_comments(gff) != golden_body("repo_fixture_HS04636.gff"):
        raise AssertionError("GFF differs from the committed golden")
    ngenes = gff.count("\tgene\t")
    if ngenes < 1:
        raise AssertionError("no gene predicted on HS04636")
    emit({"phase": "gff", "genes": ngenes, "equal_to_golden": True,
          "seconds": time.perf_counter() - t0,
          "launches": viterbi_forward.launches})

    rec = tiled_record(DATA)
    golden_full = golden_body("repo_fixture_tiled.gff")
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        stats.reset(True)
        t0 = time.perf_counter()
        gff_full = predict_records(model, [rec], device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tm = dict(stats.TIMES)
        stats.reset(False)
        if strip_comments(gff_full) != golden_full:
            raise AssertionError(f"{label} run: the full-size GFF differs "
                                 "from the committed golden")
        genes = gff_full.count("\tgene\t")
        if genes < 1:
            raise AssertionError("no gene predicted on the full sequence")
        host_prep = tm.get("prep", 0) + tm.get("build_tracks", 0) + \
            tm.get("pack", 0)
        row = {"phase": "full", "run": label, "length": len(rec.sequence),
               "genes": genes, "equal_to_golden": True,
               "host_prep_s": host_prep,
               "expand_ms": tm.get("expand", 0) * 1e3,
               "kernel_ms": tm.get("kernel", 0) * 1e3,
               "traceback_ms": tm.get("traceback", 0) * 1e3,
               "output_s": tm.get("project", 0) + tm.get("print", 0),
               "wall_s": wall, "mb_per_s": len(rec.sequence) / 1e6 / wall,
               "device_busy_share": (tm.get("expand", 0) +
                                     tm.get("kernel", 0)) / wall,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "stages_s": tm, "card": card}
        emit(row)
        runs.append(row)
    launches = viterbi_forward.launches
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")

    p = parity[-1]
    emit({"kernels": [{
        "name": "viterbi_forward", "route": "cuda",
        "source": "augustus_tpu_torch/csrc/viterbi.cu",
        "replaces": "augustus_tpu/engine/pallas_scan.py:128",
        "launches": launches, "parity": "bit-exact",
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        "ms": p["kernel_ms"], "kernel_ms": p["kernel_ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
