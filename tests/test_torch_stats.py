"""augustus_tpu_torch.stats on the CPU: stages that cost one flag check
when disabled and never synchronize when enabled, device times resolved by
flush(), the ATen op counts of the device preparation, and the cut-point
exam counters."""

import os
import time

import pytest
import torch

from augustus_tpu_torch import stats
from augustus_tpu_torch.io.fasta import FastaRecord, read_fasta
from augustus_tpu_torch.predict import Model, piece_tables, predict_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0"}


@pytest.fixture(autouse=True)
def _stats_off():
    """Each test ends with stats disabled, so that no stage or dispatch
    counting stays on for the tests after it in the same process."""
    yield
    stats.reset(False)


class FakeEvent:
    """A stand-in for torch.cuda.Event: `elapsed_ms` from the start event
    it is given, complete or not."""

    def __init__(self, elapsed_ms=0.0, done=True, **_):
        self.elapsed_ms, self.done = elapsed_ms, done
        self.recorded = self.synchronized = 0

    def record(self, stream=None):
        self.recorded += 1

    def query(self):
        return self.done

    def synchronize(self):
        self.synchronized += 1
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return end.elapsed_ms


def _forbid(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("created while stats are disabled")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(stats, "_OpCounter", boom)


def test_disabled_stage_creates_no_event_span_or_mode(monkeypatch):
    _forbid(monkeypatch)
    stats.reset(False)
    cuda = torch.device("cuda")
    with stats.stage("kernel", cuda), stats.dispatch_counts("dev_prep", cuda):
        torch.ones(3) + 1
    with stats.stage("exam"):
        pass
    assert stats.stage("kernel", cuda) is stats.stage("exam")
    assert stats.TIMES == {} and stats.COUNTS == {} and not stats._PENDING


def test_host_stage_adds_its_wall_time_and_opens_a_span():
    stats.reset(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stats.stage("exam"):
            time.sleep(0.02)
        with stats.stage("dev_prep", torch.device("cpu")):
            time.sleep(0.01)
    assert stats.TIMES["exam"] >= 0.02 and stats.TIMES["dev_prep"] >= 0.01
    assert not any(k.startswith("host:") for k in stats.TIMES)
    names = {e.name for e in prof.events()}
    assert {"stage:exam", "stage:dev_prep"} <= names


def test_cuda_stage_records_events_and_never_synchronizes(monkeypatch):
    made = []

    def event(**kw):
        made.append(FakeEvent(elapsed_ms=250.0, done=False, **kw))
        return made[-1]
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    stats.reset(True)
    with stats.stage("kernel", torch.device("cuda")):
        time.sleep(0.01)
    assert [e.recorded for e in made] == [1, 1]
    assert not any(e.synchronized for e in made)
    assert set(stats._TIMES) == {"host:kernel"}
    assert stats._TIMES["host:kernel"] >= 0.01
    assert len(stats._PENDING) == 1
    # reading TIMES flushes: the end event not yet complete is waited for
    assert stats.TIMES["kernel"] == 0.25
    assert made[1].synchronized == 1 and not stats._PENDING


def test_flush_resolves_pending_pairs():
    stats.reset(True)
    ends = [FakeEvent(100.0), FakeEvent(50.0), FakeEvent(5.0, done=False)]
    for name, end in zip(("kernel", "kernel", "traceback"), ends):
        stats._PENDING.append((name, FakeEvent(), end))
    stats.flush()
    assert stats._TIMES == pytest.approx({"kernel": 0.15, "traceback": 0.005})
    assert [e.synchronized for e in ends] == [0, 0, 1]
    assert not stats._PENDING
    stats.flush()
    assert stats.TIMES == pytest.approx({"kernel": 0.15, "traceback": 0.005})


def test_reset_drops_pending_pairs():
    stats.reset(True)
    stats._PENDING.append(("kernel", FakeEvent(), FakeEvent(100.0)))
    stats.reset(True)
    assert stats.TIMES == {} and not stats._PENDING


@pytest.mark.parametrize("op,src,dst,non_blocking,want", [
    # copies between host and card: block unless non_blocking
    ("_to_copy", "cpu", "cuda", False, (True, True)),
    ("_to_copy", "cpu", "cuda", True, (False, True)),
    ("copy_", "cpu", "cuda", False, (True, True)),
    ("_copy_from", "cpu", "cuda", False, (True, True)),
    ("_to_copy", "cuda", "cpu", False, (True, False)),
    ("copy_", "cuda", "cpu", False, (True, False)),
    ("_to_copy", "cuda", "cpu", True, (False, False)),
    # copies within one side
    ("_to_copy", "cuda", "cuda", False, (False, False)),
    ("copy_", "cpu", "cpu", False, (False, False)),
    # a value read back, outputs sized by the data
    ("_local_scalar_dense", "cuda", "cpu", False, (True, False)),
    ("equal", "cuda", "cpu", False, (True, False)),
    ("nonzero", "cuda", "cuda", False, (True, False)),
    ("masked_select", "cuda", "cuda", False, (True, False)),
    ("_unique2", "cuda", "cuda", False, (True, False)),
    ("unique_consecutive", "cuda", "cuda", False, (True, False)),
    ("repeat_interleave", "cuda", "cuda", False, (True, False)),
    ("bincount", "cuda", "cuda", False, (True, False)),
    # the same on the host, and ops that run on the card's stream
    ("_local_scalar_dense", "cpu", "cpu", False, (False, False)),
    ("nonzero", "cpu", "cpu", False, (False, False)),
    ("add", "cuda", "cuda", False, (False, False)),
    ("cummax", "cuda", "cuda", False, (False, False)),
    ("full", None, "cuda", False, (False, False)),
])
def test_transfer_classifies_each_kind(op, src, dst, non_blocking, want):
    assert stats.transfer(op, src, dst, non_blocking) == want


def test_dispatch_counts_hand_each_op_its_devices(monkeypatch):
    seen = []
    plain = stats.transfer

    def spy(op, src, dst, non_blocking):
        seen.append((op, src, dst, non_blocking))
        return plain(op, src, dst, non_blocking)
    monkeypatch.setattr(stats, "transfer", spy)
    stats.reset(True)
    with stats.dispatch_counts("probe", "meta"):
        host = torch.arange(4.0)
        torch.empty(4, device="meta").copy_(host)
        host.to("meta", non_blocking=True)
        x = torch.zeros(4, device="meta")
        x.view(2, 2)
    assert ("copy_", "cpu", "meta", False) in seen
    assert ("_to_copy", "cpu", "meta", True) in seen
    # the copies are classified, each once; empty and zeros are counted
    # without (no devices make them block or copy), the host's arange and
    # the view not at all
    assert [op for op, _, _, _ in seen] == ["copy_", "_to_copy"]
    assert stats.COUNTS == {"probe_counted": 1, "probe_ops": 4,
                            "probe_syncs": 0, "probe_h2d_bytes": 0}
    seen.clear()
    stats.reset(True)
    with stats.dispatch_counts("probe", "cpu"):
        y = torch.arange(6.0)
        y[y > 2]
        y.sum().item()
    assert ("nonzero", "cpu", "cpu", False) in seen
    assert ("_local_scalar_dense", "cpu", "cpu", False) in seen


def test_a_counter_counts_the_copies_made_below_the_dispatcher():
    stats.reset(True)
    with stats.dispatch_counts("probe", "cuda") as counter:
        # a blocking upload of 3 float32 values, as upload() records it
        counter.add("_to_copy", "cpu", "cuda", False, torch.empty(3))
        counter.add("_local_scalar_dense", "cuda", None, False, 1.0)
        counter.add("add", "cpu", "cpu", False, torch.empty(3))
        stats.upload(torch.empty(2))        # made on the host: no copy
    assert stats.COUNTS == {"probe_counted": 1, "probe_ops": 2,
                            "probe_syncs": 2, "probe_h2d_bytes": 12}


def test_only_the_first_block_after_reset_is_counted():
    stats.reset(True)
    counters = []
    for prefix in ("probe", "probe", "other", "probe"):
        with stats.dispatch_counts(prefix, "cpu") as counter:
            torch.ones(3) + 1
        counters.append(counter)
    assert [c is not None for c in counters] == [True, False, True, False]
    assert stats.COUNTS["probe_counted"] == 1
    assert stats.COUNTS["probe_ops"] == 2       # ones, add
    assert stats.COUNTS["other_ops"] == 2
    stats.reset(True)
    with stats.dispatch_counts("probe", "cpu") as counter:
        pass
    assert counter is not None


def test_cpu_device_route_counts_ops_and_no_syncs(monkeypatch):
    model = Model.load(dict(ARGS))
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    uploads = []
    plain = stats.upload

    def spy(t):
        uploads.append(t.device.type)
        plain(t)
    monkeypatch.setattr(stats, "upload", spy)
    counts = []
    for _ in range(2):
        stats.reset(True)
        _, _, route = piece_tables(model, rec, 2000, "cpu")
        assert route == "device_prep"
        counts.append(dict(stats.COUNTS))
    assert counts[0] == counts[1]
    assert counts[0]["dev_prep_counted"] == 1
    assert counts[0]["dev_prep_ops"] > 0
    assert counts[0]["dev_prep_syncs"] == 0
    assert counts[0]["dev_prep_h2d_bytes"] == 0
    # TorchXP hands every tensor it makes from Python data to upload()
    assert uploads and set(uploads) == {"cpu"}


def test_exams_and_cuts_of_a_record_in_three_pieces():
    """The first 7,500 bases of HS04636.fa at --maxDNAPieceSize=3000: three
    pieces (below 5,000 every cut lands at begin + 2,999), each cut after
    one or two exams of 3,000 bases."""
    model = Model.load(dict(ARGS, maxDNAPieceSize="3000"))
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    rec = FastaRecord(rec.name, rec.sequence[:7500])
    stats.reset(True)
    on = predict_records(model, [rec], "cpu")
    counts, times = dict(stats.COUNTS), dict(stats.TIMES)
    stats.reset(False)
    off = predict_records(model, [rec], "cpu")
    assert counts["cuts"] == 2 and counts["exams"] >= 2
    assert counts["device_prep"] == counts["exams"] + 3
    assert times["exam"] > 0 and on.count("\tgene\t") >= 1
    assert on == off
