"""augref: the benchmark's plain reference for one decoded piece.

A frozen copy of the CPU path of augustus_tpu_torch (its plain PyTorch and
NumPy versions of the Viterbi recursion, the track preparation and the
event walk, gene projection and printing), taken when that path printed
augustus_tpu's GFF byte for byte, and cut to what a window of the
benchmark's check decodes (`predict._find_genes`).  It imports neither the
program nor JAX, and runs on the CPU only.
"""
