"""FASTA input (plain or gzip), mirroring reference src/fasta.cc behavior."""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List


@dataclass
class FastaRecord:
    name: str
    sequence: str  # raw characters, case preserved (lowercase = softmasked)

    def __len__(self) -> int:
        return len(self.sequence)


def open_text(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="latin-1")
    return open(path, "r", encoding="latin-1")


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    name = None
    chunks: List[str] = []
    with open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n\r")
            if line.startswith(">"):
                if name is not None:
                    yield FastaRecord(name, "".join(chunks))
                # sequence name = first whitespace-delimited token
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif name is not None:
                # drop anything that is not a letter (digits, spaces)
                chunks.append("".join(ch for ch in line if ch.isalpha()))
    if name is not None:
        yield FastaRecord(name, "".join(chunks))


def read_fasta(path: str) -> List[FastaRecord]:
    return list(iter_fasta(path))

