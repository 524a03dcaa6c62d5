"""bam2hints CLI (reference auxprogs/bam2hints).

Usage: python -m augustus_tpu_torch.cli.bam2hints --in=aln.bam --out=hints.gff
           [--priority=4 --maxgaplen=14 --minintronlen=32
            --maxintronlen=350000 --MinEndBlockLen=8 --maxQgaplen=5
            --exonhints --ep_cutoff=10 --source=E --ssOn --nomult
            --maxgenelen=400000]

Host copy of `augustus_tpu/cli/bam2hints.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys

from ..pipeline.bam2hints import Bam2Hints


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    inp = out = None
    for a in argv:
        key, _, val = a.lstrip("-").partition("=")
        if key == "in":
            inp = val
        elif key == "out":
            out = val
        elif key in ("priority", "p"):
            kw["priority"] = int(val)
        elif key in ("maxgaplen", "g"):
            kw["maxgaplen"] = int(val)
        elif key in ("minintronlen", "m"):
            kw["minintronlen"] = int(val)
        elif key in ("maxintronlen", "M"):
            kw["maxintronlen"] = int(val)
        elif key in ("MinEndBlockLen", "b"):
            kw["min_endblock_len"] = int(val)
        elif key in ("maxQgaplen", "q"):
            kw["maxqgaplen"] = int(val)
        elif key in ("exonhints", "x"):
            kw["introns_only"] = False
        elif key in ("ep_cutoff", "e"):
            kw["ep_cutoff"] = int(val)
        elif key in ("source", "s"):
            kw["source"] = val
        elif key in ("ssOn", "S"):
            kw["ss_on"] = True
        elif key in ("nomult", "n"):
            kw["mult"] = False
        elif key in ("maxgenelen", "G"):
            kw["max_gene_len"] = int(val)
        elif key in ("help", "h"):
            sys.stderr.write(__doc__)
            return 0
    if not inp:
        sys.stderr.write(__doc__)
        return 1
    b2h = Bam2Hints(**kw)
    if out:
        with open(out, "w") as fh:
            b2h.run(inp, fh)
    else:
        b2h.run(inp, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
