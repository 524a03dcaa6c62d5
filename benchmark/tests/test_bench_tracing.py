"""The readers of the program's own spans and counters (cut-point exams,
the device preparation's ops, syncs and uploads, the batcher's cached
bytes), and the `contigs` mix of the cell `fly47.contigs`."""

import math

import pytest

from benchlib import generator as g
from benchlib import spec as S
from benchlib.reading import Reading

NEW = ("exam_ms_per_mb", "exams_per_cut", "dev_prep_host_ms_per_piece",
       "dev_prep_ops_per_piece", "dev_prep_syncs_per_piece",
       "dev_prep_h2d_mb_per_piece", "cached_free_gb")
DEV_PREP = ["dev_prep_host_ms_per_piece", "dev_prep_ops_per_piece",
            "dev_prep_syncs_per_piece", "dev_prep_h2d_mb_per_piece"]


def _reading(times=None, counts=None, pieces=None, bases=4_000_000):
    return Reading(times=times or {}, counts=counts or {}, bases=bases,
                   window_s=10.0, peak_bytes=0, work_ops=0, work_bytes=0,
                   pieces=pieces or [])


def test_readers_of_a_hand_built_reading():
    r = _reading(times={"exam": 1.6, "host:dev_prep": 2.5, "dev_prep": 0.4},
                 counts={"exams": 3, "cuts": 2, "device_prep": 20,
                         "dev_prep_counted": 5, "dev_prep_ops": 100_000,
                         "dev_prep_syncs": 1_500,
                         "dev_prep_h2d_bytes": 40_000_000},
                 pieces=[{"cached_free_bytes": 2_000_000_000},
                         {"cached_free_bytes": 7_500_000_000},
                         {"batches": 1}])
    got = {m: S.reader(m)(r) for m in NEW}
    assert got["exam_ms_per_mb"] == pytest.approx(400.0)
    assert got["exams_per_cut"] == 1.5
    assert got["dev_prep_host_ms_per_piece"] == pytest.approx(125.0)
    assert got["dev_prep_ops_per_piece"] == 20_000.0
    assert got["dev_prep_syncs_per_piece"] == 300.0
    assert got["dev_prep_h2d_mb_per_piece"] == 8.0
    assert got["cached_free_gb"] == 7.5


@pytest.mark.parametrize("name,reading", [
    # the parent's program: none of the new spans and counters
    ("exam_ms_per_mb", _reading(times={"dev_prep": 0.4})),
    ("exams_per_cut", _reading(counts={"device_prep": 5})),
    ("dev_prep_host_ms_per_piece", _reading(times={"dev_prep": 0.4},
                                            counts={"device_prep": 5})),
    ("dev_prep_ops_per_piece", _reading(counts={"device_prep": 5})),
    ("dev_prep_syncs_per_piece", _reading(counts={"device_prep": 5})),
    ("dev_prep_h2d_mb_per_piece", _reading(counts={"device_prep": 5})),
    ("cached_free_gb", _reading(pieces=[{"batches": 1, "ctas": []}])),
    # exams without a cut, counters without a device preparation, no cut
    # record, no bases
    ("exams_per_cut", _reading(counts={"exams": 0, "cuts": 0})),
    ("dev_prep_ops_per_piece", _reading(counts={"dev_prep_ops": 7,
                                                "device_prep": 5})),
    ("dev_prep_host_ms_per_piece", _reading(times={"host:dev_prep": 1.0})),
    ("cached_free_gb", _reading()),
    ("exam_ms_per_mb", _reading(times={"exam": 1.0}, bases=0)),
])
def test_readers_return_nothing_without_their_inputs(name, reading):
    assert S.reader(name)(reading) is None


def test_the_contigs_mix_has_the_stated_lengths():
    mix = S.traffic("contigs")
    lengths = g.record_lengths(mix, 2**31 + 977)
    assert len(lengths) == 72
    one_set = sorted(set(lengths))
    assert len(one_set) == 12 and all(lengths.count(n) == 6 for n in one_set)
    q = [(k + 0.5) / 12 for k in range(12)]
    assert one_set == [round(50000 * 20 ** x) for x in q]
    assert 50000 < one_set[0] < 65000 and 760000 < one_set[-1] < 1000000
    assert lengths[:12] != g.record_lengths(mix, 2**31 + 978)[:12]
    # none is cut: every record lies within the configuration's piece size
    cfg = S.config(S.load_spec(), "fly47")
    assert max(lengths) <= int(cfg["options"]["maxDNAPieceSize"])
    assert mix["warmup"]["length"] >= max(lengths)
    assert mix["check"]["at_cuts"] == 0
    rec = g.make_record(mix, 5, 0, "r1", one_set[0])
    assert len(rec.sequence) == one_set[0] and not rec.hints
    assert rec.sequence == rec.sequence.upper()
    assert math.isclose(sum(one_set) / 12, 317_000, rel_tol=0.02)


def test_the_contigs_cell_reports_the_four_dev_prep_metrics():
    sp = S.load_spec()
    cell = S.cell(sp, "fly47.contigs")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("fly47", "contigs", 1)
    assert [m["name"] for m in S.per_layer(sp, "fly47.contigs")] == DEV_PREP
    assert [m["name"] for m in S.end_to_end(sp, "fly47.contigs")] == \
        ["mb_per_s", "setup_s"]
    chrom = [m["name"] for m in S.per_layer(sp, "fly47.chrom")]
    assert set(NEW) <= set(chrom)
