"""nc intron hints of one end and several starts (tests/torch_nc_check.py:
write_multi_hints, nc_alt_donors: two seeded alternative starts beside
every intron hint of the nc hint fixture): the tracks keep every
candidate of a position in hint order (engine/device.py:
_build_nc_intronvar), K2's plain version takes the last maximum, and its
table is held to augustus_tpu's GoldEngine.run (values within TOL,
backpointers where gold's best leads its runner-up), with further
candidates winning on both strands."""

import numpy as np
import torch

import torch_nc_check
from augustus_tpu_torch.model.state_config import ST, is_nc
from torch_nc_check import TOL, compare, gold_engine, port_scan

torch.set_num_threads(1)


def test_alt_donors_held_to_gold(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_nc_check, "MULTI_DIR", str(tmp_path))
    gold = gold_engine("nc_alt_donors")
    g, tr, eng = port_scan("nc_alt_donors")
    types = g.sg.state_types
    nc = [s for s, t in enumerate(types) if is_nc(t)]
    worst, live, checked, _ = compare(gold, tr, eng, TOL, nc)
    assert worst <= TOL and checked > 4000
    bp = eng.bp.cpu().numpy()
    won = set()
    for p in tr.exon_pinned:
        if p.x_pos is None:
            continue
        for j in np.unique(p.x_pos):
            e = int(j) - (int(bp[j, p.state]) & 0xFFFFF)
            assert e == int(gold.bp_base[j, p.state])
            if e != p.eop[j]:
                won.add(types[p.state])
    assert won == {ST.ncintronvar, ST.rncintronvar}
