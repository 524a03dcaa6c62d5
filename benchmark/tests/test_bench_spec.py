"""BENCHMARK.json keeps to the contract, and cells, configurations, mixes
and per-layer metrics are found by name from data: a throwaway cell with
its own configuration, mix and metric is added as files and entries
only."""

import json
import os
import re
import shutil

from benchlib import generator as g
from benchlib import spec as S
from benchlib.reading import Reading

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_contract_shape():
    sp = S.load_spec()
    assert set(sp) == TOP
    assert 1 <= sp["run_seconds"] <= 51
    for c in sp["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        cfg = S.config(sp, c["name"])
        assert c["file"].startswith("benchmark/")
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
    for w in sp["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        S.config(sp, w["config"])
        assert "check" in S.traffic(w["traffic"])
    names = [m["name"] for m in sp["end_to_end"] + sp["per_layer"]]
    assert len(names) == len(set(names))
    for m in sp["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in sp["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in sp["end_to_end"]}
        assert callable(S.reader(m["name"]))
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in sp["workloads"]:
        e2e = {m["name"] for m in S.end_to_end(sp, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert S.per_layer(sp, w["name"])


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(S.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "augref"))
    shutil.copy(os.path.join(S.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    sp = json.loads((root / "BENCHMARK.json").read_text())
    # the new files
    cfg = json.loads((bench / "configs" / "fly47.json").read_text())
    cfg["name"] = "fly47_throwaway"
    (bench / "configs" / "fly47_throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "chrom.json").read_text())
    mix["lengths"] = {"fixed": 30000, "count": 2}
    (bench / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (bench / "metrics" / "throwaway_bases.py").write_text(
        "def read(r):\n    return float(r.bases)\n")
    # the new entries
    sp["configs"].append({"name": "fly47_throwaway", "source": "x",
                          "file": "benchmark/configs/fly47_throwaway.json",
                          "reduced": [], "why": "a test"})
    sp["workloads"].append({"name": "fly47_throwaway.tiny",
                            "config": "fly47_throwaway",
                            "traffic": "throwaway", "chips": 1,
                            "why": "a test"})
    sp["per_layer"].append({"name": "throwaway_bases", "unit": "bases",
                            "better": "higher", "source": "program_counter",
                            "layer": "test", "moves": "mb_per_s",
                            "workloads": ["fly47_throwaway.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(sp))

    sp2 = S.load_spec(str(root))
    cell = S.cell(sp2, "fly47_throwaway.tiny")
    assert S.config(sp2, cell["config"], str(root))["name"] == \
        "fly47_throwaway"
    got = S.traffic(cell["traffic"], str(bench))
    recs = g.make_records(got, 9)
    assert [len(r.sequence) for r in recs] == [30000, 30000]
    names = [m["name"] for m in S.per_layer(sp2, cell["name"])]
    assert names == ["throwaway_bases"]
    r = Reading(times={}, counts={}, bases=60000, window_s=1.0, peak_bytes=0,
                work_ops=0, work_bytes=0)
    assert S.reader("throwaway_bases", str(bench))(r) == 60000.0
    assert [m["name"] for m in S.end_to_end(sp2, cell["name"])] == \
        ["mb_per_s", "setup_s"]
    # no file that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_readers_return_nothing_without_their_reading():
    sp = S.load_spec()
    empty = Reading(times={}, counts={}, bases=0, window_s=0.0, peak_bytes=0,
                    work_ops=0, work_bytes=0)
    for m in sp["per_layer"]:
        assert S.reader(m["name"])(empty) is None, m["name"]


def test_readers_on_a_synthetic_reading():
    r = Reading(times={"prep": 0.5, "dev_prep": 0.6, "kernel": 4.0,
                       "traceback": 0.1, "project": 0.2, "print": 0.3},
                counts={"device_prep": 3}, bases=2_000_000, window_s=10.0,
                peak_bytes=5_000_000_000, work_ops=2 * 10**9,
                work_bytes=4 * 10**8,
                pieces=[{"ctas": [{"kernel": "viterbi_forward", "blocks": 3},
                                  {"kernel": "event_walk", "blocks": 3}]}],
                profile={"busy_s": 8.0, "window_s": 10.0})
    got = {m: S.reader(m)(r) for m in
           ("prep_ms_per_mb", "dev_prep_ms_per_piece", "blocks_per_launch",
            "k1_ms_per_mb", "traceback_ms_per_mb", "output_ms_per_mb",
            "device_idle_pct", "peak_mem_gb", "k1_roofline",
            "decode_mfu_pct")}
    assert got["prep_ms_per_mb"] == 250.0
    assert got["dev_prep_ms_per_piece"] == 200.0
    assert got["blocks_per_launch"] == 3.0
    assert got["k1_ms_per_mb"] == 2000.0
    assert abs(got["output_ms_per_mb"] - 250.0) < 1e-9
    assert abs(got["device_idle_pct"] - 20.0) < 1e-9
    assert got["peak_mem_gb"] == 5.0
    # 4e8 B at 3.35e12 B/s bounds it: 119.4 us over 4 s
    assert abs(got["k1_roofline"] - 100 * 4e8 / 3.35e12 / 4.0) < 1e-12
    assert abs(got["decode_mfu_pct"] - 100 * 2e9 / (10 * 67e12)) < 1e-12
