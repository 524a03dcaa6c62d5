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
--mea=1 (maximum expected accuracy over 100 sampled paths).
--alternatives-from-evidence is accepted and changes nothing, as in
augustus_tpu.  A GenBank queryfile (LOCUS and ORIGIN lines) is predicted
record by record and evaluated against its annotation, with softmasking
off unless asked for (predict.evaluate_genbank).  Comparative gene
prediction: --alnfile with --treefile and --speciesfilenames (cgp/), each
species' gene range decoded on --device.
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
    from ..io.genbank import detect_format
    from ..predict import Model, evaluate_genbank, predict_file

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
    if queryfile is None and "alnfile" not in args:
        sys.stderr.write("error: no query file\n")
        return 1
    if "alnfile" in args:
        # comparative (CGP) mode: --treefile --alnfile --speciesfilenames
        # (reference augustus.cc:129-130 -> CompGenePred::start); every
        # species' range decodes on --device
        from ..cgp import CompGenePred
        tree = args.pop("treefile")
        aln = args.pop("alnfile")
        tbl = args.pop("speciesfilenames")
        outdir = args.pop("/CompPred/outdir", ".")
        model = Model.load(args)
        cgp = CompGenePred(model, tree, aln, tbl, outdir=outdir)
        cgp.start(device)
        sys.stdout.write(HEADER.format(version=__version__))
        sys.stdout.write(f"# CGP outputs written to {outdir}\n")
        return 0
    fmt = detect_format(queryfile)
    if fmt == "genbank" and "softmasking" not in args:
        # reference: softmasking default is off for .gb files
        # (augustus.cc:218-219)
        args["softmasking"] = "0"
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
        sys.stdout.write(f"# Looks like {queryfile} is in {fmt} format.\n")
    if fmt == "genbank":
        sys.stdout.write(evaluate_genbank(model, queryfile, device=device))
    else:
        sys.stdout.write(predict_file(model, queryfile, device=device))
    cl = " ".join(["augustus"] + argv)
    sys.stdout.write(f"# command line:\n# {cl}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
