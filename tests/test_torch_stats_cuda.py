"""On an NVIDIA card: `stats.stage` makes no synchronizing runtime call,
and the device preparation's dispatcher counts (`dev_prep_syncs`,
`dev_prep_ops`) against what torch.profiler sees inside its
`stage:dev_prep` spans.  Skipped without a card (decided inside the
tests, never at import)."""

import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
SYNC_CALLS = {"cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cuStreamSynchronize",
              "cuEventSynchronize", "cuCtxSynchronize"}
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"}
COPY_CALLS = {"cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
              "cudaMemset"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    from augustus_tpu_torch import stats
    yield torch.device("cuda")
    stats.reset(False)


def _profiled(fn):
    """fn() under torch.profiler (host and card): the host-side events as
    (name, start ns, end ns)."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() != DeviceType.CUDA]


def _inside(events, span: str, names) -> list:
    """The events named in `names` that start inside a span `span`."""
    spans = [(s, e) for n, s, e in events if n == span]
    assert spans, f"no {span} span in the trace"
    return [n for n, s, _ in events if n in names
            and any(a <= s <= b for a, b in spans)]


@pytest.mark.cuda
def test_stage_makes_no_synchronizing_call(cuda):
    from augustus_tpu_torch import stats
    x = torch.randn(2048, 2048, device=cuda)
    stats.reset(True)

    def work():
        for _ in range(3):
            with stats.stage("exam"):
                with stats.stage("kernel", cuda):
                    y = x @ x
                with stats.stage("traceback", cuda):
                    y.add_(1.0)
    events = _profiled(work)
    for span in ("stage:exam", "stage:kernel", "stage:traceback"):
        assert _inside(events, span, SYNC_CALLS) == []
    times = dict(stats.TIMES)
    assert times["kernel"] > 0 and times["traceback"] > 0
    assert times["host:kernel"] > 0 and times["exam"] > 0
    assert not stats._PENDING


@pytest.mark.cuda
def test_dev_prep_counts_match_the_profiler(cuda):
    """dev_prep_syncs equals the synchronizing runtime calls inside the
    `stage:dev_prep` span (every blocking copy, `.item()` and the like
    issues one cudaStreamSynchronize).  dev_prep_ops differs from the
    launches, copies and memsets there by less than 1 %: an op that only
    allocates (empty, empty_like) issues none, and an op may issue more
    than one (on an H100, 6,000 bases of HS04636.fa: 16,361 ops against
    16,367 calls)."""
    from augustus_tpu_torch import stats
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_tables
    model = Model.load({"species": "repo_fixture",
                        "AUGUSTUS_CONFIG_PATH": CONFIG, "UTR": "off",
                        "softmasking": "0"})
    rec = read_fasta(os.path.join(ROOT, "tests", "data", "HS04636.fa"))[0]
    piece_tables(model, rec, 6000, cuda)          # kernels built, warm
    stats.reset(True)
    events = _profiled(lambda: piece_tables(model, rec, 6000, cuda))
    counts = dict(stats.COUNTS)
    syncs = _inside(events, "stage:dev_prep", SYNC_CALLS)
    launches = _inside(events, "stage:dev_prep", LAUNCH_CALLS)
    copies = _inside(events, "stage:dev_prep", COPY_CALLS)
    print(f"dev_prep counts {counts}; profiler: {len(syncs)} syncs, "
          f"{len(launches)} launches, {len(copies)} copies and memsets")
    assert counts["dev_prep_counted"] == 1
    assert counts["dev_prep_syncs"] == len(syncs)
    assert counts["dev_prep_h2d_bytes"] > 0
    work = len(launches) + len(copies)
    assert abs(counts["dev_prep_ops"] - work) <= 0.01 * work
