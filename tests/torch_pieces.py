"""Pieces of a sequence as predict_sequence hands them to
parallel/mesh.py:decode_pieces, for both packages (tests of
augustus_tpu_torch/parallel).

With --maxDNAPieceSize below 5,000 every cut point that the cut search
finds is moved to begin + size - 1 (the reference moves a cut by at least
5,000 bases, namgene.cc getNextCutEndPoint; both packages'
_next_cut_end_point), so the pieces are the blocks of `size` bases: all of
HS04636.fa (9,453 bases) at size 3,000 is 3,000, 3,000, 3,000 and 453.
The first piece has no initial synch, the last no terminal one.
"""

import importlib
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
SIZE = 3000


def blocks(n: int, size: int = SIZE):
    """(begin, end, init_synch, term_synch) of every piece."""
    return [(b, min(b + size, n) - 1, b > 0, b + size < n)
            for b in range(0, n, size)]


def piece_inputs(pkg: str, model, fasta: str, size: int = SIZE,
                 length=None):
    """The piece inputs of the first `length` bases (all with None) of the
    first record of fasta for the package `pkg` ("augustus_tpu" or
    "augustus_tpu_torch"), its model's hints cut and shifted by the
    package's own _piece_hints."""
    genetics = importlib.import_module(pkg + ".genetics")
    predict = importlib.import_module(pkg + ".predict")
    read_fasta = importlib.import_module(pkg + ".io.fasta").read_fasta
    rec = read_fasta(fasta)[0]
    seq = rec.sequence[:length]
    codes = genetics.encode(seq.lower())
    softmask = genetics.softmask_runs(seq)
    hints = model.gff_hints.get(rec.name, []) \
        if getattr(model, "gff_hints", None) is not None else None
    if hints is not None:
        hints = predict._piece_hints(hints, 0, len(seq) - 1)
    return [{"codes": codes[b: e + 1], "softmask": softmask[b: e + 1],
             "gff_hints": predict._piece_hints(hints, b, e),
             "init_synch": isyn, "term_synch": tsyn}
            for b, e, isyn, tsyn in blocks(codes.shape[0], size)]


def key(path):
    """A condensed path as comparable tuples."""
    return [(s.begin, s.end, int(s.type), s.truncated) for s in path]


def reference_paths(jmodel, pieces):
    """augustus_tpu's parallel.mesh.decode_pieces of the pieces, each
    condensed as its _find_genes condenses it."""
    from augustus_tpu.output.genes import condense_path
    from augustus_tpu.parallel.mesh import decode_pieces
    return [key(condense_path(segs, pi["codes"].shape[0]))
            for (segs, _), pi in zip(decode_pieces(jmodel, pieces), pieces)]
