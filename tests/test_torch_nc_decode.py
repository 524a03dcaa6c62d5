"""The ncRNA decode (--nc=on) of HS04636.fa with tests/data/nc_hints.gff in
the port against augustus_tpu on the CPU.  augustus_tpu decodes nc pieces
only with its host float64 engine (GoldEngine.run), the port with its
device tracks and the general Viterbi kernel K2 (here its plain version):
the Viterbi values at every live state within TOL of gold's table, every
backpointer of an nc state equal to gold's wherever gold's best candidate
leads its runner-up by more than TOL (ties within TOL are mapped in
PERF.md section 6), and the decoded segments equal to gold's traceback,
with the noncoding transcript of the hints."""

import pytest
import torch

from augustus_tpu.output.genes import condense_path
from augustus_tpu_torch.model.state_config import ST, is_nc
from torch_nc_check import TOL, compare, gold_engine, port_scan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    gold = gold_engine("nc_hints")
    _, tr, eng = port_scan("nc_hints")
    return gold, tr, eng


def test_values_and_backpointers_equal_to_gold(runs):
    gold, tr, eng = runs
    nc = [s for s, t in enumerate(gold.sg.state_types) if is_nc(t)]
    worst, live, checked, ties = compare(gold, tr, eng, TOL, nc)
    assert worst <= TOL and live > 100_000 and checked > 100
    assert len(ties) < checked


def test_segments_equal_to_gold_traceback(runs):
    gold, tr, eng = runs
    want = condense_path(gold.traceback(), gold.n)
    got = eng.traceback_path(gold.n)
    assert [(p.begin, p.end, int(p.type)) for p in got] == \
        [(p.begin, p.end, int(p.type)) for p in want]
    assert (8999, 9199, ST.ncsingle) in [(p.begin, p.end, p.type)
                                         for p in got]
