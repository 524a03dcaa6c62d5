"""Minimal BAM reader (no external deps).

BAM = BGZF-compressed binary alignment format; BGZF is a sequence of
concatenated gzip members, which Python's gzip module decompresses
transparently.  Only the fields the hint tools need are decoded
(reference bam2hints uses BamTools: RefID, Position, CigarData, flag,
name).  Spec: SAMv1.pdf section 4.2.

Host copy of `augustus_tpu/pipeline/bam.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator, List, NamedTuple, Tuple

CIGAR_OPS = "MIDNSHP=X"


class Alignment(NamedTuple):
    name: str
    flag: int
    ref_id: int
    pos: int              # 0-based leftmost coordinate
    mapq: int
    cigar: List[Tuple[int, str]]   # (length, op)


class BamReader:
    def __init__(self, path: str):
        self.fh = gzip.open(path, "rb")
        magic = self.fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self.fh.read(4))
        self.header_text = self.fh.read(l_text).decode("latin-1")
        (n_ref,) = struct.unpack("<i", self.fh.read(4))
        self.ref_names: List[str] = []
        self.ref_lengths: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self.fh.read(4))
            name = self.fh.read(l_name)[:-1].decode("latin-1")
            (l_ref,) = struct.unpack("<i", self.fh.read(4))
            self.ref_names.append(name)
            self.ref_lengths.append(l_ref)

    def __iter__(self) -> Iterator[Alignment]:
        unpack = struct.unpack
        while True:
            head = self.fh.read(4)
            if len(head) < 4:
                return
            (block_size,) = unpack("<i", head)
            data = self.fh.read(block_size)
            if len(data) < block_size:
                return
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
             _l_seq, _next_ref, _next_pos, _tlen) = unpack(
                "<iiBBHHHiiii", data[:32])
            off = 32
            name = data[off: off + l_read_name - 1].decode("latin-1")
            off += l_read_name
            cigar = []
            for _ in range(n_cigar):
                (v,) = unpack("<I", data[off: off + 4])
                off += 4
                cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
            yield Alignment(name, flag, ref_id, pos, mapq, cigar)

    def close(self) -> None:
        self.fh.close()
