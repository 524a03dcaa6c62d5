"""Byte-exact .pbl parameter-file writers.

Formats replicate the reference printProbabilities implementations
(src/exontrain.cc:339, src/introntrain.cc:608, src/igenictrain.cc:191):
LLDouble values print at output precision 3 (4 inside [EMISSION] blocks),
plain doubles at iostream precision 6.

Port of `augustus_tpu/training/pbl_write.py`: host numpy, no kernel.
"""

from __future__ import annotations

from typing import List

from .fmt import g as G, seq_inv, setw
from .models import ExonTrainer, IGenicTrainer, IntronTrainer


def _bc_str(bc) -> str:
    """BaseCount operator<< (src/motif.cc:226): '(ra, rc, rg, rt)' prec 3."""
    return "(%s, %s, %s, %s)" % tuple(G(x, 3) for x in bc)


def write_exon_pbl(t: ExonTrainer, bcs, out_path: str) -> None:
    k = t.k
    L: List[str] = []
    n_idx = len(t.gc_pls)
    for idx in range(n_idx):
        if idx == 0:
            L.append("#exon model parameters")
            L.append("# begin of content independent part")
            L.append("# start codon probabilities")
            L.append("[STARTCODONS]")
            L.append("# number of start codons:")
            L.append(str(len([c for c, p in t.start_codon_probs.items()
                              if p > 0])))
            L.append("# start codons and their probabilities")
            for c in sorted(t.start_codon_probs):
                p = t.start_codon_probs[c]
                if p > 0:
                    L.append("%s\t%s" % (seq_inv(c, 3, upper=True), G(p)))
            L.append("")
            L.append("# Length distributions")
            L.append("[LENGTH]")
            L.append("# maximal individually stored length probability =")
            L.append(str(t.exon_len_d))
            L.append("# slope of smoothing bandwidth =")
            L.append(G(t.slope_of_bandwidth, 6))
            L.append("# smoothing minwindowcount =")
            L.append(str(t.minwindowcount))
            L.append("# length single  initial  internal  terminal")
            L.append("# total number of exons of above types")
            L.append("       %d%s%s%s" % (
                t.num_single, setw(str(t.num_initial), 15),
                setw(str(t.num_internal), 15), setw(str(t.num_terminal), 15)))
            L.append("# number of exons exceeding length d")
            L.append("       %d%s%s%s" % (
                t.num_huge_single, setw(str(t.num_huge_initial), 15),
                setw(str(t.num_huge_internal), 15),
                setw(str(t.num_huge_terminal), 15)))
            L.append("# 1000 P(len=k), k=0,1,..., %d" % t.exon_len_d)
            ds, di, dt_, dte = (t.len_dist["single"], t.len_dist["initial"],
                                t.len_dist["internal"],
                                t.len_dist["terminal"])
            for i in range(t.exon_len_d + 1):
                L.append("%d\t%s\t%s\t%s\t%s"
                         % (i, G(1000 * ds[i]), G(1000 * di[i]),
                            G(1000 * dt_[i]), G(1000 * dte[i])))
            L.append("# end of content independent part")

        L.append("")
        L.append("# data set number")
        L.append("[%d]" % (idx + 1))
        L.append("# (a,c,g,t)= " + _bc_str(bcs[idx]))
        L.append("#")
        L.append("# Probabilities file for the exon model")
        L.append("#")
        L.append("")
        L.append("")
        L.append("# Die P_l's")
        L.append("[P_ls]")
        L.append("# k = %d" % k)
        pls = t.gc_pls[idx]
        for i in range(k + 1):
            L.append("# l=")
            L.append(str(i))
            L.append("# Values")
            for j in range(pls[i][0].shape[0]):
                L.append("%s\t%s\t     %s\t     %s"
                         % (seq_inv(j, i + 1), G(pls[i][0][j]),
                            G(pls[i][1][j]), G(pls[i][2][j])))
        L.append("")
        L.append("# translation initiation motif")
        L.append("[TRANSINIT]")
        t.gc_trans_init_motif[idx].write(L)
        for f in range(3):
            L.append("")
            L.append("# dss upstream motif, reading frame %d(reverse)" % f)
            L.append("[ETMOTIF%d]" % f)
            t.gc_et_motif[idx][f].write(L)
        L.append("")
        L.append("")
        L.append("#")
        L.append("# Emission probabilities")
        L.append("#")
        L.append("[EMISSION]")
        L.append("# Size of vector")
        L.append(str(t.gc_emiprobs[idx][0].shape[0]))
        L.append("# k : order of the markov model")
        L.append(str(k))
        L.append("# patpseudocount (pseudocount of sequence patterns)")
        L.append(G(t.patpseudo, 4))
        L.append("# Probabilities")
        L.append("# Format: pattern win0 win1 win2")
        em = t.gc_emiprobs[idx]
        for i in range(em[0].shape[0]):
            L.append(seq_inv(i, k + 1) + "".join(
                "\t" + G(em[f][i], 4) for f in range(3)))
        L.append("")
        L.append("")
        L.append("#")
        L.append("# Initial emission probabilities")
        L.append("#")
        L.append("[INITEMISSION]")
        L.append("# Size of vector")
        L.append(str(t.gc_initemiprobs[idx][0].shape[0]))
        L.append("# k : order of the markov model")
        L.append(str(k))
        L.append("# patpseudocount (pseudocount of sequence patterns)")
        L.append(G(t.patpseudo))
        L.append("# Probabilities")
        L.append("# Format: pattern win0 win1 win2")
        em = t.gc_initemiprobs[idx]
        for i in range(em[0].shape[0]):
            L.append(seq_inv(i, k + 1) + "".join(
                "     \t" + G(em[f][i]) for f in range(3)))
        L.append("")
        L.append("")
        L.append("#")
        L.append("# Internal exon terminal emission probabilities")
        L.append("#")
        L.append("[ETEMISSION]")
        L.append("# Size of vector")
        L.append(str(t.gc_etemiprobs[idx][0].shape[0]))
        L.append("# k : order of the markov model")
        L.append(str(k))
        L.append("# patpseudocount (pseudocount of sequence patterns)")
        L.append(G(t.patpseudo))
        L.append("# Probabilities")
        L.append("# Format: pattern win0 win1 win2")
        em = t.gc_etemiprobs[idx]
        for i in range(em[0].shape[0]):
            L.append(seq_inv(i, k + 1) + "".join(
                "     \t" + G(em[f][i]) for f in range(3)))
    with open(out_path, "w") as fh:
        fh.write("\n".join(L) + "\n")


def write_intron_pbl(t: IntronTrainer, bcs, out_path: str) -> None:
    k = t.k
    cn = t.cn
    L: List[str] = []
    n_idx = len(t.gc_emiprobs)
    for idx in range(n_idx):
        if idx == 0:
            L.append("#intron model parameters")
            L.append("# begin of content independent part")
            L.append("#")
            L.append("# ASS probabilities")
            L.append("#only nonpseudocount values are shown")
            L.append("[ASS]")
            L.append("# Size of vector")
            L.append(str(t.assprobs.shape[0]))
            L.append("# c_ass (ASS count)")
            L.append(str(t.c_ass))
            L.append("# asspseudocount (added to all possible patterns, "
                     "no matter if they occur)")
            L.append(G(t.asspseudo))
            L.append("# Probabilities * 1000")
            mincount = (t.asspseudo + 0.5) \
                / (float(t.c_ass) + t.assprobs.shape[0] * t.asspseudo)
            for i in range(t.assprobs.shape[0]):
                if t.assprobs[i] > mincount:
                    L.append("%s\t%s" % (seq_inv(i, cn.ass_size),
                                         G(1000 * t.assprobs[i])))
            L.append("")
            L.append("")
            L.append("#")
            L.append("# DSS probabilities")
            L.append("#only nonpseudocount values are shown")
            L.append("[DSS]")
            L.append("# Size of vector")
            L.append(str(t.dssprobs.shape[0]))
            L.append("# c_dss (DSS count)")
            L.append(str(t.c_dss))
            L.append("# dsspseudocount (added to all possible patterns, "
                     "no matter if they occur)")
            L.append(G(t.dsspseudo))
            L.append("# Probabilities * 1000")
            for i in range(t.dssprobs.shape[0]):
                L.append("%s\t%s" % (seq_inv(i, cn.dss_size),
                                     G(1000 * t.dssprobs[i])))
            L.append("")
            L.append("#")
            L.append("# Length probabilities")
            L.append("#")
            L.append("[LENGTH]")
            L.append("# The 'd' variable")
            L.append(str(t.d))
            L.append("# The length probabilities from '0' to 'd' (*1000) ")
            for i in range(t.len_dist.shape[0]):
                L.append(G(1000 * t.len_dist[i]))
            L.append("# end of content independent part")
        L.append("[%d]" % (idx + 1))
        L.append("# (a,c,g,t)= " + _bc_str(bcs[idx]))
        L.append("#")
        L.append("# Probabilities file for the intron model")
        L.append("#")
        L.append("#")
        L.append("# Transition probabilities")
        L.append("#")
        L.append("[TRANSITION]")
        L.append("# the probability of an intron of length at most d")
        L.append(G(t.gc_prob_short[idx]))
        L.append("# mean additional length of introns with length > d")
        L.append(G(t.gc_mal[idx]))
        L.append("")
        L.append("#")
        L.append("# The emission probabilities of introns")
        L.append("#")
        L.append("[EMISSION]")
        L.append("# size of the emission vector")
        L.append(str(t.gc_emiprobs[idx].shape[0]))
        L.append("#k=")
        L.append(str(k))
        L.append("# patpseudo : pseudocount for sequence patterns")
        L.append(G(t.patpseudo, 4))
        em = t.gc_emiprobs[idx]
        for i in range(em.shape[0]):
            L.append("%s\t%s" % (seq_inv(i, k + 1), G(em[i], 4)))
        L.append("")
        L.append("# patterns:")
        for j in range(t.emicount.shape[0]):
            L.append("#\t%s\t%d" % (seq_inv(j, k + 1), t.emicount[j]))
        L.append("")
        L.append("# motif upstream of acceptor splice site")
        L.append("[ASSMOTIF]")
        t.gc_ass_motif[idx].write(L)
    with open(out_path, "w") as fh:
        fh.write("\n".join(L) + "\n")


def write_igenic_pbl(t: IGenicTrainer, bcs, out_path: str,
                     intron: IntronTrainer = None,
                     tie_igenic_intron: bool = True) -> None:
    k = t.k
    L: List[str] = []
    n_idx = len(t.gc_pls)
    for idx in range(n_idx):
        L.append("[%d]" % (idx + 1))
        L.append("# (a,c,g,t)= " + _bc_str(bcs[idx]))
        L.append("#")
        L.append("# Probabilities file for the intergenic region model")
        L.append("#")
        L.append("")
        L.append("# k =")
        L.append(str(k))
        L.append("")
        L.append("# The P_l's")
        L.append("[P_ls]")
        pls = t.gc_pls[idx]
        for i in range(k + 1):
            L.append("# l=")
            L.append(str(i))
            L.append("# Values")
            for j in range(pls[i].shape[0]):
                L.append("%s\t%s" % (seq_inv(j, i + 1, upper=True),
                                     G(pls[i][j])))
        # emission probs; with tieIgenicIntron the intron model's current-gc
        # emissions are written instead (reference quirk: uses the static
        # gcIdx, src/igenictrain.cc:235)
        if tie_igenic_intron and intron is not None:
            em = intron.gc_emiprobs[getattr(intron, "gc_idx", 0)]
        else:
            em = t.gc_emiprobs[idx]
        L.append("")
        L.append("[EMISSION]")
        L.append("")
        L.append("# Vector size (4^(k+1))")
        L.append(str(em.shape[0]))
        L.append("# Probabilities")
        for i in range(em.shape[0]):
            L.append("%s\t%s" % (seq_inv(i, k + 1, upper=True), G(em[i], 4)))
    with open(out_path, "w") as fh:
        fh.write("\n".join(L) + "\n")


def write_utr_pbl(t, bcs, out_path: str) -> None:
    """UTR model .pbl writer (reference UtrModel::printProbabilities,
    src/utrtrain.cc:883-1016)."""
    k = t.k
    L: List[str] = []
    n_idx = len(t.gc_utr5)
    for idx in range(n_idx):
        if idx == 0:
            L.append("# UTR model parameters")
            L.append("# begin of content independent part")
            L.append("")
            L.append("# Length distributions")
            L.append("[UTRLENGTH]")
            L.append("# maximal individually stored length probability d=")
            L.append(str(t.exonLenD))
            L.append("# slope of smoothing bandwidth =")
            L.append(G(t.slope, 6))
            L.append("# smoothing minwindowcount =")
            L.append(str(t.minwindowcount))
            L.append("# length 5' sing  5' init  5' int  5' term  3' sing"
                     "  3' init  3' int  3' term ")
            L.append("# total number of exons of above types")
            keys = ("5s", "5i", "5n", "5t", "3s", "3i", "3n", "3t")
            L.append("".join(setw(str(t.num[key]), 10) for key in keys))
            L.append("# number of exons exceeding length d=%d" % t.exonLenD)
            L.append("".join(setw(str(t.num_huge[key]), 10)
                             for key in keys))
            L.append("# 1000 P(len=k), k=0,1,..., %d" % t.exonLenD)
            for i in range(t.exonLenD + 1):
                L.append(str(i) + "".join(
                    "\t" + G(1000 * t.len_dists[key][i]) for key in keys))
            L.append("#")
            L.append("# AATAAA/TGTAA box probabilities")
            L.append("[AATAAA]")
            L.append("# Size of vector")
            L.append(str(t.aataaa_probs.shape[0]))
            L.append("# Probabilities")
            for i in range(t.aataaa_probs.shape[0]):
                if t.aataaa_probs[i] > 0.0:
                    L.append("%s\t%s" % (seq_inv(i, t.boxlen),
                                         G(t.aataaa_probs[i])))
            L.append("# end of content independent part")
        L.append("[%d]" % (idx + 1))
        L.append("# (a,c,g,t)= " + _bc_str(bcs[idx]))
        L.append("#")
        L.append("# Probabilities file for the UTR model")
        L.append("#")
        L.append("#")
        L.append("")
        L.append("#")
        L.append("# The emission probabilities of single and initial"
                 " 5' UTR exons")
        L.append("#")
        L.append("[EMISSION-5INITIAL]")
        L.append("# size of the emission vector")
        L.append(str(t.gc_utr5init[idx].shape[0]))
        L.append("#k=")
        L.append(str(k))
        L.append("# patpseudo : pseudocount for sequence patterns")
        L.append(G(t.patpseudo))
        for i in range(t.gc_utr5init[idx].shape[0]):
            L.append("%s\t%s" % (seq_inv(i, k + 1), G(t.gc_utr5init[idx][i])))
        L.append("")
        L.append("#")
        L.append("# The emission probabilities of internal and terminal"
                 " 5' UTR exons")
        L.append("#")
        L.append("[EMISSION-5]")
        L.append("# size of the emission vector")
        L.append(str(t.gc_utr5[idx].shape[0]))
        L.append("#k=")
        L.append(str(k))
        L.append("# patpseudo : pseudocount for sequence patterns")
        L.append(G(t.patpseudo))
        for i in range(t.gc_utr5[idx].shape[0]):
            L.append("%s\t%s" % (seq_inv(i, k + 1), G(t.gc_utr5[idx][i])))
        L.append("")
        L.append("#")
        L.append("# The emission probabilities of 3' UTR exons")
        L.append("#")
        L.append("[EMISSION-3]")
        L.append("# size of the emission vector")
        L.append(str(t.gc_utr3[idx].shape[0]))
        L.append("#k=")
        L.append(str(k))
        L.append("# patpseudo : pseudocount for sequence patterns")
        L.append(G(t.patpseudo))
        for i in range(t.gc_utr3[idx].shape[0]):
            L.append("%s\t%s" % (seq_inv(i, k + 1), G(t.gc_utr3[idx][i])))
        L.append("")
        L.append("#")
        L.append("# The emission probabilities of the tss upwindow")
        L.append("#")
        L.append("[EMISSION-TSSUPWIN]")
        L.append("# size of the emission vector")
        L.append(str(t.gc_tssup[idx].shape[0]))
        L.append("#tssup_k=")
        L.append(str(t.tssup_k))
        L.append("# patpseudo : pseudocount for sequence patterns")
        L.append(G(t.tssup_patpseudo))
        for i in range(t.gc_tssup[idx].shape[0]):
            L.append("%s\t%s" % (seq_inv(i, t.tssup_k + 1),
                                 G(t.gc_tssup[idx][i])))
        L.append("")
        L.append("# motif around the TSS of TATA-less promoters")
        L.append("[TSSMOTIF]")
        t.gc_tss_motif[idx].write(L)
        L.append("")
        L.append("# motif around the TSS of TATA promoters")
        L.append("[TSSMOTIFTATA]")
        t.gc_tss_motif_tata[idx].write(L)
        L.append("")
        L.append("# tata box motif ")
        L.append("[TATAMOTIF]")
        t.gc_tata_motif[idx].write(L)
        L.append("")
        L.append("# motif after polyA signal")
        L.append("[TTSMOTIF]")
        t.gc_tts_motif[idx].write(L)
    with open(out_path, "w") as fh:
        fh.write("\n".join(L) + "\n")
