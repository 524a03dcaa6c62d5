"""The benchmark's count of a decode's work, against the figures of
augustus_tpu_torch/engine/viterbi.py:kernel_work on HS04636.fa (9,453
bases: 9,652,404 bytes and 60,775,129 operations, PR 6).  kernel_work
counts what K1 computes (a dense max over every predecessor lane and every
begin of each variant's band); this counts what the recursion needs (the
85 transitions of the table, the begins that the open reading frames
allow), so it is smaller, but of the same size."""

import os

from benchlib import generator as g
from benchlib import work
from benchlib.spec import BENCH_DIR

K1_BYTES, K1_OPS = 9_652_404, 60_775_129


def _arch():
    return work.architecture(os.path.join(BENCH_DIR, "augustus_config"),
                             "repo_fixture")


def test_architecture_from_the_files():
    a = _arch()
    assert (a.states, a.transitions) == (47, 85)
    assert (a.max_exon_len, a.min_intron_len, a.intron_d) == (15000, 39, 100)


def test_counts_of_the_same_size_as_kernel_work():
    seq = g.read_fasta(os.path.join(g.SEQ_DIR, "HS04636.fa"))[0][1]
    ops = work.viterbi_ops(seq, _arch())
    nbytes = work.viterbi_bytes(seq, _arch())
    assert K1_OPS / 20 < ops < K1_OPS
    assert K1_BYTES / 20 < nbytes < K1_BYTES


def test_counts_follow_the_letters():
    a = _arch()
    seq = g.read_fasta(os.path.join(g.SEQ_DIR, "HS04636.fa"))[0][1]
    assert work.viterbi_ops(seq + seq, a) > work.viterbi_ops(seq, a)
    # no stop codon and no signal: only the chain
    assert work.viterbi_ops("C" * 1000, a) == 1000 * (2 * 85 + 47)
    assert work.total_work([seq, seq], a) == (
        2 * work.viterbi_ops(seq, a), 2 * work.viterbi_bytes(seq, a))
