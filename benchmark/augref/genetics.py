"""Nucleotide encoding, genetic code, and k-mer pattern indexing.

Everything is vectorized over NumPy int8 code arrays (a=0, c=1, g=2, t=3,
anything else=4) — the framework's replacement for the reference's per-char
``Seq2Int`` (include/geneticcode.hh:163) and ``GeneticCode`` predicates
(src/geneticcode.cc).  Pattern index convention matches the reference: the
first base of a pattern is the most significant base-4 digit; ``rc`` packs the
complement of base i at significance i (reverse complement).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

_CODE = np.full(256, N, dtype=np.int8)
for _ch, _v in (("a", A), ("c", C), ("g", G), ("t", T)):
    _CODE[ord(_ch)] = _v
    _CODE[ord(_ch.upper())] = _v

_SOFTMASK = np.zeros(256, dtype=bool)
for _ch in "acgtn":
    _SOFTMASK[ord(_ch)] = True  # lowercase letters = repeat-softmasked

COMPLEMENT = np.array([T, G, C, A, N], dtype=np.int8)

INT2BASE = np.array(list("acgtn"))


def encode(seq: str) -> np.ndarray:
    """DNA string -> int8 codes (0..3, 4 for non-acgt)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _CODE[raw]


def softmask_runs(seq: str) -> np.ndarray:
    """Boolean per-base mask: True where the base is lowercase (softmasked)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _SOFTMASK[raw]


def decode(codes: np.ndarray) -> str:
    return "".join(INT2BASE[np.asarray(codes, dtype=np.int64)])


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


def kmer_ids(codes: np.ndarray, k: int) -> np.ndarray:
    """Pattern index of the k-mer *starting* at each position (len = n-k+1).

    Positions whose window contains a non-acgt base get index -1.
    First base is the most significant digit (reference Seq2Int::operator())."""
    from .engine.xputil import A, astype
    xp = A.xp
    n = codes.shape[0]
    if n < k:
        return xp.zeros(0, dtype=np.int64)
    c64 = astype(codes, np.int64)
    ids = xp.zeros(n - k + 1, dtype=np.int64)
    bad = xp.zeros(n - k + 1, dtype=bool)
    for i in range(k):
        ids = (ids << 2) | xp.where(c64[i:n - k + 1 + i] == N, 0,
                                    c64[i:n - k + 1 + i])
        bad = bad | (c64[i:n - k + 1 + i] == N)
    return xp.where(bad, -1, ids)


def rc_kmer_ids(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement pattern index of the k-mer starting at each position.

    Matches reference Seq2Int::rc: digit i (significance 4**i) is the
    complement of base i of the window."""
    from .engine.xputil import A, astype
    xp = A.xp
    n = codes.shape[0]
    if n < k:
        return xp.zeros(0, dtype=np.int64)
    comp = astype(xp.asarray(COMPLEMENT)[codes], np.int64)
    ids = xp.zeros(n - k + 1, dtype=np.int64)
    bad = xp.zeros(n - k + 1, dtype=bool)
    for i in range(k):
        ids = ids | (xp.where(comp[i:n - k + 1 + i] == N, 0,
                              comp[i:n - k + 1 + i]) << (2 * i))
        bad = bad | (comp[i:n - k + 1 + i] == N)
    return xp.where(bad, -1, ids)


# ---------------------------------------------------------------------------
# Genetic code.  Codon index = b0*16 + b1*4 + b2 (first base most significant).
# ---------------------------------------------------------------------------

def codon_index(codon: str) -> int:
    idx = 0
    for ch in codon:
        idx = idx * 4 + int(_CODE[ord(ch)])
    return idx


# The reference's translation tables (src/geneticcode.cc:57-101), one
# 64-char string per NCBI table number in codon-lexicographic order
# (aaa=0 .. ttt=63, a<c<g<t — matches codon_index).  Empty string = table
# not defined; chooseTranslationTable falls back to table 1 then.
_TRANSLATION_TABLES = {
    1:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    2:  "KNKNTTTT*S*SMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    3:  "KNKNTTTTRSRSMIMIQHQHPPPPRRRRTTTTEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    4:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    5:  "KNKNTTTTSSSSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    6:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVQYQYSSSS*CWCLFLF",
    9:  "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    10: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSCCWCLFLF",
    11: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    12: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLSLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    13: "KNKNTTTTGSGSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    14: "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYY*YSSSSWCWCLFLF",
    15: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YQYSSSS*CWCLFLF",
    16: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YLYSSSS*CWCLFLF",
    21: "NNKNTTTTSSSSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    22: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YLY*SSS*CWCLFLF",
    23: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWC*FLF",
    24: "KNKNTTTTSSKSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
}

# start-codon masks per table (src/geneticcode.cc StartCodons, 'M' =
# codon may start translation; the trained start-codon frequencies gate
# which ones actually score > 0 — GeneticCode::startCodonProb)
_START_CODON_MASKS = {
    1:  "--------------M---------------M-------------------------------M-",
    2:  "------------MMMM------------------------------M-----------------",
    3:  "------------M-M-------------------------------------------------",
    4:  "------------MMMM--------------M---------------M-------------M-M-",
    5:  "------------MMMM------------------------------M---------------M-",
    6:  "--------------M-------------------------------------------------",
    9:  "--------------M-------------------------------M-----------------",
    10: "--------------M-------------------------------------------------",
    11: "------------MMMM--------------M---------------M---------------M-",
    12: "--------------M---------------M---------------------------------",
    13: "------------M-M-------------------------------M---------------M-",
    14: "--------------M-------------------------------------------------",
    15: "--------------M-------------------------------------------------",
    16: "--------------M-------------------------------------------------",
    21: "--------------M-------------------------------M-----------------",
    22: "--------------M-------------------------------------------------",
    23: "--------------MM------------------------------M-----------------",
    24: "--------------M---------------M---------------M---------------M-",
}

NUM_TRANSTABS = 24


class GeneticCode:
    """Codon translation + start/stop predicates for one translation table.

    All the reference's tables (src/geneticcode.cc:57-101, NCBI numbering
    with gaps at 7, 8, 17-20) including the per-table start-codon sets;
    out-of-range or undefined numbers fall back to the standard table 1
    exactly like GeneticCode::chooseTranslationTable (geneticcode.cc:146).
    """

    def __init__(self, table: int = 1):
        if table > NUM_TRANSTABS or table < 0 or \
                table not in _TRANSLATION_TABLES:
            table = 1
        self.table = table
        self.aa_of_codon = np.array(list(_TRANSLATION_TABLES[table]))
        self.is_stop = self.aa_of_codon == "*"
        # codon indices that may start translation under this table; the
        # trained start-codon frequencies decide their actual weight
        # (engine/gold.py start_prob tracks)
        self.start_codons = {
            c: 1.0 for c, ch in enumerate(_START_CODON_MASKS[table])
            if ch == "M"}

    # vectorized per-position predicates ------------------------------------
    def stop_at(self, codes: np.ndarray) -> np.ndarray:
        """Boolean array: True at position i if codes[i:i+3] is a stop codon.

        Length n; last two positions are False.
        """
        from .engine.xputil import A, astype
        xp = A.xp
        n = codes.shape[0]
        if n < 3:
            return xp.zeros(n, dtype=bool)
        c = astype(codes, np.int64)
        idx = c[:-2] * 16 + c[1:-1] * 4 + c[2:]
        valid = (c[:-2] != N) & (c[1:-1] != N) & (c[2:] != N)
        head = valid & xp.asarray(self.is_stop)[xp.where(valid, idx, 0)]
        return xp.concatenate([head, xp.zeros(2, dtype=bool)])

    def rc_stop_at(self, codes: np.ndarray) -> np.ndarray:
        """True at i if codes[i:i+3] is the reverse complement of a stop codon
        (i.e. a stop codon read on the minus strand): tta, cta, tca for the
        standard code."""
        from .engine.xputil import A, astype
        xp = A.xp
        n = codes.shape[0]
        if n < 3:
            return xp.zeros(n, dtype=bool)
        c = astype(codes, np.int64)
        comp = astype(xp.asarray(COMPLEMENT)[codes], np.int64)
        # reverse complement codon = comp(b2) comp(b1) comp(b0)
        idx = comp[2:] * 16 + comp[1:-1] * 4 + comp[:-2]
        valid = (c[:-2] != N) & (c[1:-1] != N) & (c[2:] != N)
        head = valid & xp.asarray(self.is_stop)[xp.where(valid, idx, 0)]
        return xp.concatenate([head, xp.zeros(2, dtype=bool)])
