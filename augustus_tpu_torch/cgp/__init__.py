"""Comparative gene prediction (CGP) — the multi-genome mode.

Reference: src/compgenepred.cc (driver), src/alignment.cc / genomicMSA.cc
(MAF handling and gene ranges), src/exoncand.cc (exon candidates),
src/orthoexon.cc / geneMSA.cc (ortho exon tuples), src/phylotree.cc /
contTimeMC.cc (phylogenetic models), src/speciesgraph.cc / orthograph.cc
(per-species DAGs + dual decomposition).

Port of `augustus_tpu/cgp/`: host copies (numpy and the standard
library, the same iteration orders, float formats and output text), with
one call to the card: each species' gene range is decoded by the port's
`predict._find_genes` on `CompGenePred.start(device=...)`'s device, on
the device route (csrc/prefix.cu, the Viterbi kernel K1, the event walk
K4), or through K2 where a kernel's capacity sends it
(`predict._engine`).  Phylogenetic likelihood (Felsenstein pruning over
the exon gain/loss model) is one vectorized numpy pass per tree node over
all ortho exons at once instead of the reference's per-HECT GSL loops.
"""

from .compgenepred import CompGenePred  # noqa: F401
