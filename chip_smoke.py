#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (augustus_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernel from the sources in the checkout,
and exits non-zero on any failure (nothing is caught, nothing falls back to
the CPU or to a kernel's plain version).  Phases, one JSON line each:

  device  card name and power limit (nvidia-smi)
  build   nvcc of csrc/viterbi.cu (set-up time; nvcc's -Xptxas=-v report
          of registers, shared memory and spills goes to stderr)
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
  gff     predict_file(..., device="cuda") on HS04636.fa, byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_HS04636.gff
  gff_hints  the same on HS04636sm.fa with --softmasking=1, its hints
          file and extrinsic.M.RM.E.W.cfg, evidence blocks included,
          byte-equal to repo_fixture_HS04636sm_hints.gff
  full    ab-initio prediction on the 1,023,095-base sequence of
          augustus_tpu_torch/io/tiled.py: one cold run, then one warm run
          with the per-stage breakdown, each byte-equal to
          augustus_tpu_torch/data/golden/repo_fixture_tiled.gff
  full_hints  the same letters softmasked, with the EST hints of every
          inserted gene (io/tiled.py:tiled_hinted), cold and warm, each
          byte-equal to repo_fixture_tiled_hints.gff
Then the kernels line, the card line and the final status line.  The GFF
comparisons leave out comment lines.
"""

from __future__ import annotations

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


def model_args(species: str, hints=None) -> dict:
    """The species' arguments; with a hints file name, softmasking on and
    the EST hints with extrinsic.M.RM.E.W.cfg."""
    if hints is None:
        return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
                "UTR": "off", "softmasking": "0"}
    return {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "off", "softmasking": "1",
            "hintsfile": os.path.join(HINTS, hints),
            "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}


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


def phase_full(phase, model, rec, golden, card, extra):
    """One cold and one warm prediction of rec, each held to golden."""
    import torch
    from augustus_tpu_torch import stats
    from augustus_tpu_torch.predict import predict_records
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
        if strip_comments(gff_full) != golden:
            raise AssertionError(f"{phase} {label} run: the full-size GFF "
                                 "differs from the committed golden")
        genes = gff_full.count("\tgene\t")
        if genes < 1:
            raise AssertionError(f"{phase}: no gene predicted")
        host_prep = tm.get("prep", 0) + tm.get("build_tracks", 0) + \
            tm.get("pack", 0)
        row = {"phase": phase, "run": label, "length": len(rec.sequence),
               "genes": genes, "equal_to_golden": True, **extra,
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
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from augustus_tpu_torch.engine import _build
    from augustus_tpu_torch.engine.viterbi import viterbi_forward
    from augustus_tpu_torch.io.tiled import tiled_hinted, tiled_record
    from augustus_tpu_torch.predict import Model, predict_file

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.load("viterbi")
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    # the chunks of length None (the whole sequence) are the gff and
    # gff_hints phases' inputs
    parity = phase_parity(device, [
        ("repo_fixture", "HS04636.fa", 6000, None),
        ("repo_fixture_gc2", "HS04636.fa", 6000, None),
        ("repo_fixture", "HS04636.fa", None, None),
        ("repo_fixture", "HS04636sm.fa", None, "HS04636sm.E.gff"),
        ("repo_fixture", "HS04636rc.fa", 6000, "HS04636rc.E.gff")])

    # ---- main path: GFF parity, then full size; counts from here on ----
    viterbi_forward.launches = 0
    viterbi_forward.hinted_launches = 0
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

    hmodel = Model.load(model_args("repo_fixture", "HS04636sm.E.gff"))
    t0 = time.perf_counter()
    before = viterbi_forward.hinted_launches
    gff = predict_file(hmodel, os.path.join(DATA, "HS04636sm.fa"),
                       device="cuda")
    if strip_comments(gff) != golden_body(
            "repo_fixture_HS04636sm_hints.gff"):
        raise AssertionError("hinted GFF differs from the committed golden")
    ngenes = gff.count("\tgene\t")
    if ngenes < 1 or "# Evidence for and against" not in gff:
        raise AssertionError("no gene or no evidence block on HS04636sm")
    emit({"phase": "gff_hints", "genes": ngenes, "equal_to_golden": True,
          "seconds": time.perf_counter() - t0,
          "hinted_launches": viterbi_forward.hinted_launches - before})

    rec = tiled_record(DATA)
    phase_full("full", model, rec, golden_body(
        "repo_fixture_tiled.gff"), card, {})
    hrec, hint_lines = tiled_hinted(DATA)
    with open(os.path.join(HINTS, "tiled_sm.E.gff")) as fh:
        if fh.read() != "".join(hint_lines):
            raise AssertionError("tiled_sm.E.gff is not tiled_hinted's hints")
    hmodel = Model.load(model_args("repo_fixture", "tiled_sm.E.gff"))
    counts = {"hints": len(hint_lines),
              "rm_runs": len(re.findall("[acgtn]+", hrec.sequence)),
              "softmasked_share": sum(map(str.islower, hrec.sequence))
              / len(hrec.sequence)}
    phase_full("full_hints", hmodel, hrec, golden_body(
        "repo_fixture_tiled_hints.gff"), card, counts)
    launches = viterbi_forward.launches
    hinted = viterbi_forward.hinted_launches
    if launches < 1 or hinted < 1:
        raise AssertionError(f"the main path launched the kernel {launches} "
                             f"times, {hinted} of them with hints")

    p, ph = parity[2], parity[3]
    emit({"kernels": [{
        "name": "viterbi_forward", "route": "cuda",
        "source": "augustus_tpu_torch/csrc/viterbi.cu",
        "replaces": "augustus_tpu/engine/pallas_scan.py:128",
        "launches": launches, "parity": "bit-exact",
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        "ms": p["kernel_ms"], "kernel_ms": p["kernel_ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"], "library_ms": None}, {
        "name": "viterbi_forward:hint_quot", "route": "cuda",
        "source": "augustus_tpu_torch/csrc/viterbi.cu",
        "replaces": "augustus_tpu/engine/pallas_scan.py:134",
        "launches": hinted, "parity": "bit-exact",
        "max_abs_err": max(r["max_abs_err"] for r in parity[3:]),
        "ms": ph["kernel_ms"], "kernel_ms": ph["kernel_ms"],
        "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
        "bound_by": ph["bound_by"], "library_ms": None}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
