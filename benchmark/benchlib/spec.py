"""BENCHMARK.json and the files it names, found by name.

A cell's configuration is the JSON file that its `configs` entry names;
its traffic mix is `benchmark/traffic/<traffic>.json`; a per-layer metric
is read by `benchmark/metrics/<name>.py`'s `read(reading)`.  Adding a
configuration, a mix, a cell or a metric adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, _named(spec["configs"], name,
                                        "config")["file"])) as fh:
        return json.load(fh)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as fh:
        return json.load(fh)


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(spec: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics that the cell reports (--trace 0)."""
    return [m for m in spec["end_to_end"] if _applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics that the cell reports (--trace 1): those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read` of benchmark/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
