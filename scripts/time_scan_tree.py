#!/usr/bin/env python3
"""Time the general Viterbi kernel K2 (csrc/scan.cu) and its logsumexp
twin K5 (csrc/scan_lse.cu) of the tree this runs from, on chip_smoke.py's
scan pieces, on one NVIDIA card; one JSON line per piece with a hash of
K2's backpointers, final column and values and K5's rows.

Unlike scripts/compare_k2_builds.py, which launches two builds on one
tree's descriptor, each tree here runs its own Python and kernels, so two
trees whose descriptor layouts differ can be compared: unpack the other
tree under build/ and run, in turns, from each root:

    git archive <commit> | tar -x -C build/parent
    (cd build/parent && python3 ../../scripts/time_scan_tree.py parent)
    python3 scripts/time_scan_tree.py change

Equal hashes mean bit-equal outputs.  Times: the fewest ms of two means
of three launches (CUDA events).  The card's name and power limit first.
"""

import hashlib
import json
import os
import sys


def main(tag: str) -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from augustus_tpu_torch.engine import _build
    from augustus_tpu_torch.engine.scan import scan_forward, scan_table
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    if not torch.cuda.is_available():
        raise SystemExit("time_scan_tree: no CUDA device")
    _build.build_all(("scan", "scan_lse"))
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)

    def fasta(name):
        return read_fasta(os.path.join(cs.DATA, name))[0]
    utr = Model.load(dict(cs.model_args("repo_fixture_utr"), **cs.UTR_PRINT))
    pieces = [
        ("HS04636_6kb", utr, fasta("HS04636.fa"), 6000),
        ("HS04636sm_hints", Model.load(cs.model_args(
            "repo_fixture_utr", "HS04636sm.E.gff")), fasta("HS04636sm.fa"),
         None),
        ("47_state_6kb", Model.load(cs.model_args("repo_fixture")),
         fasta("HS04636.fa"), 6000),
        ("nc_HS04636_hints", Model.load(cs.nc_args("gff_nc")),
         fasta("HS04636.fa"), None),
        ("nc_HS08198_fixture", Model.load(cs.nc_args("gff_nc_fixture")),
         fasta("HS08198.fa"), None)]
    for name, model, rec, n in pieces:
        st, t, v0, _ = piece_scan(model, rec, n, dev)
        outs = scan_forward(st, t, v0, debug_vals=True) + (
            scan_table(st, t, v0),)
        torch.cuda.synchronize()
        h = hashlib.sha1()
        for x in outs:
            h.update(x.cpu().numpy().tobytes())
        k2 = min(cs.time_cuda(lambda: scan_forward(st, t, v0), 3)
                 for _ in range(2))
        k5 = min(cs.time_cuda(lambda: scan_table(st, t, v0), 3)
                 for _ in range(2))
        print(json.dumps({"tree": tag, "piece": name, "n": st.n, "S": st.S,
                          "k2_ms": k2, "k5_ms": k5, "sha1": h.hexdigest()}),
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
