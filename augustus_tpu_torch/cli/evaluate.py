"""Standalone accuracy evaluation of two GenBank files.

Usage: python -m augustus_tpu_torch.cli.evaluate annofile predictfile

Port of `augustus_tpu/cli/evaluate.py`; it runs no kernel.

Reference: src/evaluate.cc — reads both files as GenBank, pairs the
sequences in order (names must match), accumulates sensitivity /
specificity over both strands and prints the accuracy tables.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.stderr.write("Usage:\nevaluate annofile predictfile\n")
        return 1
    annofile, predfile = argv[0], argv[1]
    from ..io.genbank import read_genbank
    from ..output.evaluation import Evaluation
    from ..predict import anno_to_gene

    anno = read_genbank(annofile)
    pred = read_genbank(predfile)
    if len(anno) != len(pred):
        sys.stderr.write("The two input files didn't contain the same "
                         "number of sequences in the same order.\n")
        return 1
    ev = Evaluation()
    for a, p in zip(anno, pred):
        if a.seqname != p.seqname:
            sys.stderr.write("The two input files didn't contain the same "
                             "number of sequences in the same order.\n")
            return 1
        anno_genes = [anno_to_gene(tg, a.seqname) for tg in a.genes]
        pred_genes = [anno_to_gene(tg, p.seqname) for tg in p.genes]
        ev.add_to_evaluation(pred_genes, anno_genes, strand="both")
    out: list = []
    ev.finish(out)
    ev.print_quotients(out)
    ev.print_tables(out)
    sys.stdout.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
