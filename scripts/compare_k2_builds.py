#!/usr/bin/env python3
"""Time the general Viterbi kernel K2 (csrc/scan.cu) of the checkout
against another tree's, in turns, on the same pieces, on one NVIDIA card.

    git archive <commit> augustus_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/compare_k2_builds.py build/parent/augustus_tpu_torch/csrc

Both libraries are built from source (engine/_build.py, one per tree:
the hash of a library covers its sources) and launched on the checkout's
tables and descriptor, in the order checkout, other, other, checkout, each
timed with CUDA events (mean of three launches).  Their values,
backpointers and final columns must be bit-equal.  Pieces: 6 kb of
HS04636.fa with the UTR fixture (71 states), all of HS04636sm.fa with its
EST hints (the hint quotient), 6 kb with the 47-state repo_fixture, and
the --nc=on pieces of chip_smoke.py's gff_nc.  One JSON line per piece;
the card's name and power limit first.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(other: str) -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from augustus_tpu_torch.engine import _build
    from augustus_tpu_torch.engine.scan import scan_forward
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    if not torch.cuda.is_available():
        raise SystemExit("compare_k2_builds: no CUDA device")
    ours, other = _build.CSRC, os.path.abspath(other)

    def use(csrc):
        _build.CSRC = csrc
        _build._loaded.clear()
    for csrc in (other, ours):
        use(csrc)
        _build.build_all(("scan",))
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)

    def fasta(name):
        return read_fasta(os.path.join(cs.DATA, name))[0]
    utr = Model.load(dict(cs.model_args("repo_fixture_utr"), **cs.UTR_PRINT))
    pieces = [
        ("HS04636_6kb", utr, fasta("HS04636.fa"), 6000, True),
        ("HS04636sm_hints", Model.load(cs.model_args(
            "repo_fixture_utr", "HS04636sm.E.gff")), fasta("HS04636sm.fa"),
         None, True),
        ("47_state_6kb", Model.load(cs.model_args("repo_fixture")),
         fasta("HS04636.fa"), 6000, True),
        ("nc_HS04636_hints", Model.load(cs.nc_args("gff_nc")),
         fasta("HS04636.fa"), None, False),
        ("nc_HS08198_fixture", Model.load(cs.nc_args("gff_nc_fixture")),
         fasta("HS08198.fa"), None, False)]
    for name, model, rec, n, both in pieces:
        st, t, v0, _ = piece_scan(model, rec, n, dev)
        times, outs = {}, {}
        # a tree without the nc quotient class cannot take an nc piece
        order = ("ours", "other", "other", "ours") if both else ("ours",)
        for tag in order:
            use(ours if tag == "ours" else other)
            outs[tag] = scan_forward(st, t, v0, debug_vals=True)
            times.setdefault(tag, []).append(
                cs.time_cuda(lambda: scan_forward(st, t, v0), 3))
        row = {"piece": name, "n": st.n, "S": st.S, "NHW": st.NHW,
               "ms": times["ours"], "us_per_position":
               sum(times["ours"]) / len(times["ours"]) * 1e3 / st.n}
        if both:
            bp, vf, vals = outs["ours"]
            obp, ovf, ovals = outs["other"]
            if not (torch.equal(vals.view(torch.int32),
                                ovals.view(torch.int32))
                    and torch.equal(bp, obp)
                    and torch.equal(vf.view(torch.int32),
                                    ovf.view(torch.int32))):
                raise AssertionError(f"{name}: the two builds differ")
            row.update(other_ms=times["other"], bit_equal=True)
        print(json.dumps(row), flush=True)
    use(ours)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
