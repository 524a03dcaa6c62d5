"""The work a Viterbi decode of a record needs, counted by the benchmark.

Counted from the configuration's files (the state architecture, its
transition table, the species' exon and intron lengths) and the record's
letters, never from the tensors of the program, so that the count stays
the same whatever kernel or layout implements the recursion.

Operations (float adds and compares) at every position of a strand pair:

* chain: one add and one max for each transition of the table
  (`[Transition]` of the architecture's `.pbl`), one add per state for its
  emission;
* exons: at each position where an exon may end (before a donor `GT` for
  the initial and internal exons of each of the three exit phases, at the
  last base of a stop codon for the single and terminal exons; mirrored on
  the reverse strand), one entry for each begin that the open reading frame
  of that frame allows (back to the last in-frame stop codon, at most the
  species' maxexonlength), 4 operations each: the emission sum, the length
  term, the predecessor's value and the max;
* short introns: at each position where an intron may end (before the
  acceptor's `AG`, mirrored), for each of the three phases, one entry for
  each length from minintronlen to /IntronModel/d, 4 operations each.

Bytes: each letter read once (1 byte), the model's tables once (their
numbers as float32), and the traceback plane written once: one 32-bit word
per state and position.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable

import numpy as np

OPS_PER_ENTRY = 4
BYTES_PER_LETTER = 1
BYTES_PER_BACKPOINTER = 4

_CODE = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


@dataclass
class Architecture:
    states: int
    transitions: int
    table_numbers: int
    max_exon_len: int
    min_intron_len: int
    intron_d: int


def _cfg_values(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split("#")[0].split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def _numbers(path: str) -> int:
    """How many numbers a parameter file holds (its tables' size)."""
    num = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")
    count = 0
    with open(path) as fh:
        for line in fh:
            if line.lstrip().startswith("#"):
                continue
            count += sum(1 for t in line.split() if num.match(t))
    return count


def architecture(config_path: str, species: str) -> Architecture:
    """The sizes of the 47-state architecture and the species' tables."""
    model = os.path.join(config_path, "model")
    states = int(_cfg_values(os.path.join(
        model, "states_shadow.cfg"))["/NAMGene/statecount"])
    transitions, section = 0, None
    with open(os.path.join(model, "trans_shadow_partial.pbl")) as fh:
        for line in fh:
            s = line.split("#")[0].strip()
            if s.startswith("["):
                section = s
            elif section == "[Transition]" and len(s.split()) == 3:
                transitions += 1
    sp_dir = os.path.join(config_path, "species", species)
    params = _cfg_values(os.path.join(sp_dir, f"{species}_parameters.cfg"))
    tables = sum(_numbers(os.path.join(sp_dir, f)) for f in
                 sorted(os.listdir(sp_dir)) if f.endswith(".pbl"))
    return Architecture(
        states=states, transitions=transitions, table_numbers=tables,
        max_exon_len=int(params.get("/ExonModel/maxexonlength", 15000)),
        min_intron_len=int(params.get("/IntronModel/minintronlen", 39)),
        intron_d=int(params.get("/IntronModel/d", 100)))


def _orf_window_sum(codes: np.ndarray, ends: np.ndarray, stop_start,
                    frame_of_end, cap: int) -> int:
    """Sum over the exon ends of the begins that the open reading frame of
    the end's frame allows: the distance back to the end of the last
    in-frame stop codon that lies wholly before the end, at most cap."""
    n = codes.shape[0]
    total = 0
    idx = np.arange(n)
    for f in range(3):
        stop_end = np.full(n, -1, dtype=np.int64)
        s = stop_start[(stop_start % 3) == f]
        stop_end[s + 2] = s + 2
        last = np.maximum.accumulate(stop_end)
        sel = ends[frame_of_end[ends] == f]
        if sel.size == 0:
            continue
        # a stop codon that ends at the exon's own last base is excluded
        prev = np.where(stop_end[sel] == sel,
                        np.maximum.accumulate(np.r_[-1, stop_end[:-1]])[sel],
                        last[sel])
        total += int(np.minimum(idx[sel] - prev, cap).sum())
    return total


def _strand_entries(codes: np.ndarray, arch: Architecture) -> int:
    """Exon and short-intron entries of one strand (the letters as read
    on that strand)."""
    n = codes.shape[0]
    if n < 3:
        return 0
    a, c, g, t = 0, 1, 2, 3
    c0, c1, c2 = codes[:-2], codes[1:-1], codes[2:]
    stop = np.flatnonzero((c0 == t) & (((c1 == a) & ((c2 == a) | (c2 == g)))
                                      | ((c1 == g) & (c2 == a))))
    donor = np.flatnonzero((codes[:-1] == g) & (codes[1:] == t)) - 1
    donor = donor[donor >= 0]
    acc = np.flatnonzero((codes[:-1] == a) & (codes[1:] == g)) + 1
    entries = 0
    # initial and internal exons of each exit phase end before a donor; the
    # three phases put the reading frame on each of the three frames
    idx = np.arange(n)
    for phase in range(3):
        frame = (idx - 2 - phase) % 3
        entries += 2 * _orf_window_sum(codes, donor, stop, frame,
                                       arch.max_exon_len)
    # single and terminal exons end with their stop codon
    stop_last = stop + 2
    frame = (idx - 2) % 3
    entries += 2 * _orf_window_sum(codes, stop_last, stop, frame,
                                   arch.max_exon_len)
    lessd = max(arch.intron_d - arch.min_intron_len + 1, 0)
    entries += int(acc.size) * 3 * lessd
    return entries


def encode(letters: str) -> np.ndarray:
    return _CODE[np.frombuffer(letters.encode("latin-1"), dtype=np.uint8)]


def viterbi_ops(letters: str, arch: Architecture) -> int:
    """The operations a Viterbi decode of the letters needs."""
    codes = encode(letters)
    n = codes.shape[0]
    rc = np.where(codes < 4, 3 - codes, 4)[::-1].copy()
    chain = n * (2 * arch.transitions + arch.states)
    entries = _strand_entries(codes, arch) + _strand_entries(rc, arch)
    return chain + OPS_PER_ENTRY * entries


def viterbi_bytes(letters: str, arch: Architecture) -> int:
    """The bytes a Viterbi decode of the letters must move."""
    n = len(letters)
    return (n * BYTES_PER_LETTER + arch.table_numbers * 4
            + n * arch.states * BYTES_PER_BACKPOINTER)


def total_work(records: Iterable[str], arch: Architecture):
    """(operations, bytes) of decoding each of the letters once."""
    ops = byt = 0
    for letters in records:
        ops += viterbi_ops(letters, arch)
        byt += viterbi_bytes(letters, arch)
    return ops, byt
