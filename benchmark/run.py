"""The benchmark of augustus_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  A run sets up (the configuration's species
through `Model.load`, the cell's records and hints from the seed, a warm-up
record of the same kind), sends the records one after another through
`predict.predict_records(model, [record], device)` for `--seconds`, checks
windows of their GFF against the plain reference (benchlib.correct), and
prints one JSON line last: with --trace 0 the cell's end-to-end metrics,
with --trace 1 (stages timed, torch.profiler over the window) its
per-layer metrics.  Cells, configurations, traffic mixes and per-layer
metrics are found by name (BENCHMARK.json, benchmark/configs,
benchmark/traffic, benchmark/metrics).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _paths() -> None:
    """The checkout's build and kernel caches, one host thread for the
    numeric libraries (one process with few threads keeps the host's share
    of a run steady), and the import paths."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    for p in (BENCH_DIR, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


class Cell:
    """A cell set up for one seed: the program's model, the records, the
    warm-up done."""

    def __init__(self, name: str, seed: int, device, spec=None, cfg=None,
                 mix=None):
        import torch
        from benchlib import generator, spec as S
        from augustus_tpu_torch import predict
        from augustus_tpu_torch.io.fasta import FastaRecord
        self.spec = S.load_spec() if spec is None else spec
        self.cell = S.cell(self.spec, name)
        self.cfg = S.config(self.spec, self.cell["config"]) \
            if cfg is None else cfg
        self.mix = S.traffic(self.cell["traffic"]) if mix is None else mix
        self.seed = seed
        self.device = torch.device(device)
        self.predict = predict
        self.config_path = os.path.join(ROOT, self.cfg["config_path"])
        self.records = generator.make_records(self.mix, seed)
        warm = generator.make_warmup(self.mix, seed)
        self._tmp = tempfile.TemporaryDirectory(prefix="bench-hints-")
        self.hints_path = generator.write_hints(
            self.records + [warm], os.path.join(self._tmp.name, "hints.gff"))
        args = dict(self.cfg["options"])
        if self.hints_path is not None:
            args["hintsfile"] = self.hints_path
        self.model = predict.Model.load(args, self.config_path)
        self.fasta = [FastaRecord(r.name, r.sequence) for r in self.records]
        self.lengths = [len(r.sequence) for r in self.records]
        self.pieces = []          # each call's pieces, for the check
        self._cut = None
        self._plain_cut = plain_cut = predict.cut_pieces

        def cut_pieces(*args, **kw):
            pieces = plain_cut(*args, **kw)
            self._cut = [(int(b), int(e)) for b, e, _, _ in pieces]
            return pieces
        predict.cut_pieces = cut_pieces
        self.call(FastaRecord(warm.name, warm.sequence))
        self.pieces = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, rec) -> str:
        """One record through the entry, its pieces recorded (the cut
        points that its exams chose), in the order of the calls."""
        self._cut = None
        try:
            return self.predict.predict_records(self.model, [rec],
                                                self.device)
        finally:
            self.pieces.append(self._cut)

    def free(self) -> None:
        """Drop the program's state (the model and its device memory)."""
        import torch
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def close(self) -> None:
        self.predict.cut_pieces = self._plain_cut
        self._tmp.cleanup()


def measure(cell: Cell, seconds: float, trace: bool):
    """The window: (done, reading or None)."""
    import torch
    from benchlib import window
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    if not trace:
        return window.closed_loop(cell.fasta, seconds, cell.call), None
    from augustus_tpu_torch import stats
    from augustus_tpu_torch.parallel import mesh
    from benchlib import trace as T
    pieces = []

    def call(rec):
        mesh.decode_pieces.last = None
        out = cell.call(rec)
        if mesh.decode_pieces.last is not None:
            pieces.append(mesh.decode_pieces.last)
        return out

    spans = T.StageSpans(stats)
    stats.reset(True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            done = window.closed_loop(cell.fasta, seconds, call)
            if cuda:
                torch.cuda.synchronize(cell.device)
            window_s = time.perf_counter() - t0
        times, counts = dict(stats.TIMES), dict(stats.COUNTS)
    finally:
        stats.reset(False)
        spans.restore()
    return done, (prof, window_s, times, counts, pieces)


def per_layer(cell: Cell, done, traced, peak_bytes: int) -> tuple:
    """The cell's per-layer metrics and the trace's device fields."""
    from benchlib import spec as S, trace as T, work
    from benchlib.reading import Reading
    prof, window_s, times, counts, pieces = traced
    profile = T.read_profile(prof, window_s)
    letters = [cell.records[d.index].sequence for d in done
               if d.output is not None]
    arch = work.architecture(cell.config_path, cell.cfg["options"]["species"])
    ops, nbytes = work.total_work(letters, arch)
    r = Reading(times=times, counts=counts, bases=sum(map(len, letters)),
                window_s=window_s, peak_bytes=peak_bytes, work_ops=ops,
                work_bytes=nbytes, pieces=pieces, profile=profile)
    for p in pieces:
        print("pieces: " + json.dumps(p), file=sys.stderr)
    metrics = {}
    for m in S.per_layer(cell.spec, cell.cell["name"]):
        v = S.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics, profile


def finished(cell: Cell, done) -> tuple:
    """([(name, length, gff text, pieces)], [letters]) of the finished
    records (cell.pieces holds the window's calls in order)."""
    ok = [(d, p) for d, p in zip(done, cell.pieces) if d.output is not None]
    return ([(cell.records[d.index].name, cell.lengths[d.index], d.output,
              p) for d, p in ok],
            [cell.records[d.index].sequence for d, _ in ok])


def verify(cell: Cell, done) -> dict:
    """benchlib.correct over the finished records."""
    from benchlib import correct
    fin, letters = finished(cell, done)
    if not fin:
        return {"windows": 0, "windows_at_cuts": 0, "bases": 0, "genes": 0,
                "gff_lines_differing": 0, "per_window": [], "transcripts": 0,
                "transcripts_malformed": 0, "malformed": []}
    return correct.check(fin, letters, cell.mix["check"], cell.seed,
                         cell.config_path, cell.cfg["options"],
                         cell.hints_path)


def checks_of(result: dict, check_spec: dict) -> dict:
    """Each number compared, beside its limit."""
    from benchlib.correct import limits
    return {k: {"value": result[k], "limit": lim}
            for k, (_, lim) in limits(check_spec).items()}


def is_correct(result: dict, failed: int, check_spec: dict) -> bool:
    from benchlib.correct import passed
    return failed == 0 and passed(result, check_spec)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device=None, spec=None, cfg=None, mix=None, fault=None):
    """One run: (the result line as a dict, the check's details).  `device`
    None: the cell's chips, and a run without them fails.  `fault(cell)` is
    called after set-up (tests plant faults in the timed path with it)."""
    import torch
    from benchlib import nojax, spec as S
    sp = S.load_spec() if spec is None else spec
    chips = int(S.cell(sp, args.workload)["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell needs {chips} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = "cuda:0"
    kernels = os.path.join(ROOT, "build", "kernels")
    before = set(os.listdir(kernels)) if os.path.isdir(kernels) else set()
    cell = Cell(args.workload, args.seed, device, sp, cfg, mix)
    built = sorted((set(os.listdir(kernels)) if os.path.isdir(kernels)
                    else set()) - before)
    if built:
        print("set-up built: " + " ".join(built), file=sys.stderr)
    try:
        if fault is not None:
            fault(cell)
        setup_s = time.perf_counter() - T0
        print(f"setup_s {setup_s:.3f}", file=sys.stderr)
        cuda = cell.device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(cell.device) \
            if cuda else 0
        done, traced = measure(cell, args.seconds, bool(args.trace))
        window_peak = torch.cuda.max_memory_allocated(cell.device) \
            if cuda else 0
        failed = sum(1 for d in done if d.output is None)
        print("window: " + " ".join(
            f"{cell.records[d.index].name}:{cell.lengths[d.index]}@"
            f"{d.end_s:.3f}s" for d in done), file=sys.stderr)
        for d in done:
            if d.error:
                print(f"record {cell.records[d.index].name}: {d.error}",
                      file=sys.stderr)
        device_info = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(cell.device) if cuda
            else "cpu", "count": chips,
            "memory_peak_bytes": int(max(setup_peak, window_peak))}
        line = {"attempted": len(done), "failed": failed}
        if traced is None:
            from benchlib.window import mb_per_s
            values = {"mb_per_s": mb_per_s(done, cell.lengths),
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in S.end_to_end(sp, args.workload)}
        else:
            metrics, profile = per_layer(cell, done, traced, window_peak)
            device_info["window_s"] = traced[1]
            traced = None       # the profiler's events go before the check
            if profile is not None:
                device_info["busy_s"] = profile["busy_s"]
                line["breakdown"] = {"device_ops": profile["device_ops"],
                                     "idle_gaps": profile["idle_gaps"]}
        cell.free()
        result = verify(cell, done)
    finally:
        cell.close()
    line.update({"correct": is_correct(result, failed, cell.mix["check"]),
                 "metrics": metrics, "device": device_info})
    line["checks"] = checks_of(result, cell.mix["check"])
    bad = nojax.forbidden_modules()
    if bad:
        raise SystemExit("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(bad))
    return line, result


def main(argv=None) -> int:
    _paths()
    args = parse(argv)
    try:
        import augustus_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 1
    line, detail = run(args)
    from benchlib.correct import limits
    print(f"check: {detail['windows']} windows ({detail['windows_at_cuts']} "
          f"at cut points), {detail['bases']} bases, {detail['genes']} "
          f"genes, lines differing per window {detail['per_window']}; "
          f"{detail['transcripts']} transcripts held to the letters "
          f"{detail['malformed']}", file=sys.stderr)
    rels = limits({})
    for k, v in line["checks"].items():
        print(f"{k} {v['value']} limit {rels[k][0]} {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0 if line["device"]["platform"] == "gpu" else 1


if __name__ == "__main__":
    sys.exit(main())
