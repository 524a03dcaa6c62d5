"""augustus-compatible command line interface of the PyTorch/CUDA port.

Usage: python -m augustus_tpu_torch.cli.augustus [--key=value ...] [--device=cpu|cuda] queryfile
Mirrors `augustus_tpu/cli/augustus.py` (reference src/augustus.cc):
--species is required, input is FASTA, output is GFF/GTF on stdout.
--device selects where the kernels run (default cuda).  Softmasking
(--softmasking=1) and hints (--hintsfile, --extrinsicCfgFile) as in the
reference.  Sampling as in the reference: --sample=N (N >= 10 paths drawn
from the forward table, fewer is none), --alternatives-from-sampling=true
(report the sampled alternative transcripts), --keep_viterbi,
--minexonintronprob, --minmeanexonintronprob (posterior filters) and
--temperature=0..7 (heat the forward table and the walk by (8 - t) / 8).
Comparative gene prediction (--alnfile), MEA (--mea), alternatives from
evidence (--alternatives-from-evidence), GenBank input and evaluation are
not ported.
"""

from __future__ import annotations

import sys
from typing import Dict, List


def parse_argv(argv: List[str]):
    args: Dict[str, str] = {}
    queryfile = None
    for a in argv:
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                k, v = body.split("=", 1)
            else:
                k, v = body, "true"
            args[k] = v
        else:
            queryfile = a
    return args, queryfile


HEADER = """\
# This output was generated with AUGUSTUS-TPU (augustus_tpu_torch {version}).
# A PyTorch/CUDA port of the TPU-native reimplementation of AUGUSTUS
# (Stanke et al.); sources and documentation: see the repository README.
"""


def main(argv=None) -> int:
    from .. import __version__
    from ..io.fasta import looks_like_fasta
    from ..predict import Model, predict_file

    argv = argv if argv is not None else sys.argv[1:]
    args, queryfile = parse_argv(argv)
    if queryfile is None and "queryfile" in args:
        queryfile = args.pop("queryfile")
    device = args.pop("device", "cuda")
    if "outfile" in args:
        sys.stdout = open(args.pop("outfile"), "w")
    if "errfile" in args:
        sys.stderr = open(args.pop("errfile"), "w")
    if "species" not in args:
        sys.stderr.write("error: no species specified (--species=...)\n")
        return 1
    if "alnfile" in args:
        raise NotImplementedError("comparative gene prediction (--alnfile) "
                                  "is not ported")
    if queryfile is None:
        sys.stderr.write("error: no query file\n")
        return 1
    if not looks_like_fasta(queryfile):
        raise NotImplementedError("only FASTA input is ported (GenBank "
                                  "input and evaluation are not)")
    try:
        verbosity = int(args.get("/augustus/verbosity",
                                 args.get("verbosity", "1")))
    except ValueError:
        verbosity = 1
    model = Model.load(args)
    sys.stdout.write(HEADER.format(version=__version__))
    if verbosity and "hintsfile" not in args:
        sys.stdout.write("# No extrinsic information on sequences given.\n")
    elif verbosity:
        sys.stdout.write(f"# reading in the file {args['hintsfile']} ...\n")
        nseq = len(model.gff_hints) if model.gff_hints else 0
        sys.stdout.write(f"# Have extrinsic information about {nseq} "
                         "sequences (in the specified range). \n")
    if verbosity > 1:
        cfgdir = args.get("AUGUSTUS_CONFIG_PATH",
                          model.props.get("AUGUSTUS_CONFIG_PATH", ""))
        sys.stdout.write("# Initializing the parameters using config "
                         f"directory {cfgdir} ...\n")
    if verbosity > 2:
        sys.stdout.write(f"# Looks like {queryfile} is in fasta format.\n")
    sys.stdout.write(predict_file(model, queryfile, device=device))
    cl = " ".join(["augustus"] + argv)
    sys.stdout.write(f"# command line:\n# {cl}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
