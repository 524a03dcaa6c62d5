"""The closed loop and the rate arithmetic of mb_per_s."""

import pytest

from benchlib import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_closed_loop_rate_on_a_synthetic_timeline():
    clock = Clock()
    cost = {"a": 4.0, "b": 6.0, "c": 5.0}

    def call(rec):
        clock.t += cost[rec]
        return "gff of " + rec

    done = window.closed_loop(["a", "b", "c"], 12.0, call, clock)
    # a ends at 4, b at 10, c at 15 (started at 10 < 12), then stop
    assert [d.index for d in done] == [0, 1, 2]
    assert [d.end_s for d in done] == [4.0, 10.0, 15.0]
    lengths = [1_000_000, 2_000_000, 3_000_000]
    assert window.mb_per_s(done, lengths) == pytest.approx(6.0 / 15.0)


def test_records_cycle_and_a_failed_call_adds_time_not_bases():
    clock = Clock()

    def call(rec):
        clock.t += 2.0
        if rec == "bad":
            raise RuntimeError("no")
        return "ok"

    done = window.closed_loop(["ok", "bad"], 5.0, call, clock)
    assert [d.index for d in done] == [0, 1, 0]
    assert done[1].output is None and "RuntimeError" in done[1].error
    assert window.mb_per_s(done, [500_000, 500_000]) == \
        pytest.approx(1.0 / 6.0)


def test_first_record_runs_even_with_no_seconds():
    clock = Clock()

    def call(rec):
        clock.t += 1.0
        return rec

    done = window.closed_loop(["x"], 0.0, call, clock)
    assert len(done) == 1
