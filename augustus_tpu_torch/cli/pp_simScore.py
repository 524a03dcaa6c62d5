"""pp_simScore CLI (reference src/pp_simscore.cc main).

Usage: python -m augustus_tpu_torch.cli.pp_simScore --fasta <protein.fa> \
           --prfl <fam.prfl> [--out score] [--gap_inter -5] ...
Implemented output modes: score (default), interblock, bp, consents.

Host copy of `augustus_tpu/cli/pp_simScore.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys

from ..ppx.simscore import SimilarityScore
from ..ppx.profile import AA_SYMBOLS



def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = {"gap_inter": -5.0, "gap_intra": -50.0, "gap_intron": -5.0,
            "intron_weight_intra": 5.0, "intron_weight_inter": 5.0,
            "epsilon_intron": 1e-7, "epsilon_noIntron": 0.1}
    fasta = prfl = None
    out = "score"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key = a[2:]
            if "=" in key:
                key, val = key.split("=", 1)
            else:
                i += 1
                val = argv[i] if i < len(argv) else ""
            if key == "fasta":
                fasta = val
            elif key == "prfl":
                prfl = val
            elif key == "out":
                out = val
            elif key in opts:
                opts[key] = float(val)
        i += 1
    if not fasta or not prfl:
        sys.stderr.write("USAGE: pp_simScore --fasta <protein.fa> "
                         "--prfl <fam.prfl> [--out score]\n")
        return 1
    ss = SimilarityScore(
        gap_inter=opts["gap_inter"], gap_intra=opts["gap_intra"],
        gap_intron=opts["gap_intron"],
        intron_weight_intra=opts["intron_weight_intra"],
        intron_weight_inter=opts["intron_weight_inter"],
        epsi_intron=opts["epsilon_intron"],
        epsi_no_intron=opts["epsilon_noIntron"])
    ss.read(fasta, prfl)
    if out == "interblock":
        for b in range(ss.prfl.block_count()):
            d = ss.prfl[b].distance
            print(f"{d.min}\t{d.max if d.has_max else '*'}")
        d = ss.prfl.final_dist
        print(f"{d.min}\t{d.max if d.has_max else '*'}")
        return 0
    if out == "bp":
        for b in range(ss.prfl.block_count()):
            print(f"{b}\t{ss.prfl[b].block_numb_in_file}")
        return 0
    if out == "consents":
        for b in range(ss.prfl.block_count()):
            blk = ss.prfl[b]
            am = blk.values.argmax(axis=1)
            print("".join(AA_SYMBOLS[int(a)] for a in am))
        return 0
    ss.fill()
    print(f"{ss.score():.6g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
