"""Global model constants derived from configuration.

Mirrors the reference ``Constant`` block (include/types.hh:304-412,
src/types.cc Constant::init) but as an instantiable dataclass rather than
global mutable state.
"""

from __future__ import annotations

from dataclasses import dataclass

from .properties import Properties

# fixed-size signal middles (reference include/types.hh:59-62)
ASS_MIDDLE = 2      # the "ag" acceptor dinucleotide
DSS_MIDDLE = 2      # the "gt" donor dinucleotide
STARTCODON_LEN = 3
STOPCODON_LEN = 3


@dataclass
class Constants:
    trans_init_window: int = 12
    ass_upwindow_size: int = 20
    init_coding_len: int = 16
    et_coding_len: int = 5
    ass_start: int = 2
    ass_end: int = 2
    dss_start: int = 2
    dss_end: int = 5
    tss_upwindow_size: int = 0
    tss_start: int = 5
    decomp_num_at: int = 1
    decomp_num_gc: int = 1
    decomp_num_steps: int = 1
    min_coding_len: int = 102
    max_exon_len: int = 12000
    gc_range_min: float = 0.32
    gc_range_max: float = 0.73
    prob_n_in_coding: float = 0.23
    opalprob: float = 0.333
    amberprob: float = 0.333
    ochreprob: float = 0.333
    dss_gc_allowed: bool = False
    tie_igenic_intron: bool = True
    min_intron_len: int = 39
    gc_win_size: int = 10000
    temperature: int = 0
    softmasking: bool = True
    max_dna_piece_size: int = 200000
    min_exon_length: int = 1

    # -- derived sizes ------------------------------------------------------
    @property
    def dss_size(self) -> int:
        return self.dss_start + self.dss_end

    @property
    def dss_whole_size(self) -> int:
        return self.dss_start + DSS_MIDDLE + self.dss_end

    @property
    def ass_size(self) -> int:
        return self.ass_start + self.ass_end

    @property
    def ass_whole_size(self) -> int:
        return self.ass_start + ASS_MIDDLE + self.ass_end

    @property
    def ass_outside(self) -> int:
        # bases of the acceptor region upstream of (before) the lessD segment
        return self.ass_upwindow_size + self.ass_start + ASS_MIDDLE

    @classmethod
    def from_properties(cls, props: Properties) -> "Constants":
        c = cls()
        g = props
        c.trans_init_window = g.get_int("/Constant/trans_init_window", c.trans_init_window)
        c.ass_upwindow_size = g.get_int("/Constant/ass_upwindow_size", c.ass_upwindow_size)
        c.init_coding_len = g.get_int("/Constant/init_coding_len", c.init_coding_len)
        c.et_coding_len = g.get_int("/Constant/intterm_coding_len", c.et_coding_len)
        c.ass_start = g.get_int("/Constant/ass_start", c.ass_start)
        c.ass_end = g.get_int("/Constant/ass_end", c.ass_end)
        c.dss_start = g.get_int("/Constant/dss_start", c.dss_start)
        c.dss_end = g.get_int("/Constant/dss_end", c.dss_end)
        c.tss_upwindow_size = g.get_int("/Constant/tss_upwindow_size", c.tss_upwindow_size)
        c.tss_start = g.get_int("/UtrModel/tss_start", c.tss_start)
        c.decomp_num_at = g.get_int("/Constant/decomp_num_at", c.decomp_num_at)
        c.decomp_num_gc = g.get_int("/Constant/decomp_num_gc", c.decomp_num_gc)
        c.decomp_num_steps = g.get_int("/Constant/decomp_num_steps", c.decomp_num_steps)
        c.min_coding_len = g.get_int("/Constant/min_coding_len", c.min_coding_len)
        c.max_exon_len = g.get_int("/ExonModel/maxexonlength", c.max_exon_len)
        c.gc_range_min = g.get_float("/Constant/gc_range_min", c.gc_range_min)
        c.gc_range_max = g.get_float("/Constant/gc_range_max", c.gc_range_max)
        c.prob_n_in_coding = g.get_float("/Constant/probNinCoding", c.prob_n_in_coding)
        c.opalprob = g.get_float("/Constant/opalprob", c.opalprob)
        c.amberprob = g.get_float("/Constant/amberprob", c.amberprob)
        c.ochreprob = g.get_float("/Constant/ochreprob", c.ochreprob)
        c.dss_gc_allowed = g.get_bool("/IntronModel/allow_dss_consensus_gc", c.dss_gc_allowed)
        c.tie_igenic_intron = g.get_bool("tieIgenicIntron", c.tie_igenic_intron)
        c.min_intron_len = g.get_int("/IntronModel/minintronlen", c.min_intron_len)
        c.gc_win_size = g.get_int("GCwinsize", c.gc_win_size)
        c.temperature = g.get_int("temperature", c.temperature)
        c.softmasking = g.get_bool("softmasking", c.softmasking)
        c.max_dna_piece_size = g.get_int("maxDNAPieceSize", c.max_dna_piece_size)
        c.min_exon_length = g.get_int("/ExonModel/minexonlength", c.min_exon_length)
        return c
