"""The one traffic generator: records (and their hints) from a mix's data.

A frozen copy of the tiling in `augustus_tpu_torch/io/tiled.py`
(`_tiled_layout`, `tiled_hinted`, `gene_hints`, `exon_free_hints`),
widened to draw everything from `--seed`: the repository's genomic
sequences (`benchmark/sequences/`: HS04636.fa, HS08198.fa and the
sequences of genes_crf3.gb, genes_test1.gb and utrtrain.gb) sit, in a
seeded order, between uniform-ACGT spacers, until a record reaches its
length.  A mix (`benchmark/traffic/<name>.json`) gives:

  lengths     {"fixed": n, "count": k} or {"loguniform": [lo, hi],
              "count": k, "sets": m}: the same set of record lengths for
              every seed (log-uniform: the k mid-quantiles), m times over,
              each time in another seeded order
  spacer      [lo, hi] bases of uniform ACGT before each sequence
  softmask    null, or {"gap": [lo, hi], "run": [lo, hi]}: lower-case
              repeat runs of run bases, gap bases apart
  hints       null, or {"signals_every": 2, "drop": [feature types]}:
              the EST-style hints of every inserted gene (`gene_hints`),
              with start/stop/dss/ass hints on every other part, without
              the listed feature types
  warmup      {"length": n}: the set-up's record of the same kind, at
              full size where the window's records are cut into pieces
              (the caching allocator then holds what the window holds)
  check       the windows of the correctness check (benchlib/correct.py)

The same seed gives the same records, letter for letter.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

SEQ_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sequences")


@dataclass
class Record:
    name: str
    sequence: str
    hints: List[str] = field(default_factory=list)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64)] + [s % (1 << 32)
                                                         for s in stream])


def read_fasta(path: str) -> List[Tuple[str, str]]:
    out, name, cur = [], None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(cur)))
                name, cur = line[1:].split()[0], []
            elif line:
                cur.append(line)
    if name is not None:
        out.append((name, "".join(cur)))
    return out


def genbank_sequences(path: str) -> List[str]:
    """The ORIGIN sequences of a GenBank file (letters only)."""
    seqs, cur = [], None
    with open(path) as fh:
        for line in fh:
            if line.startswith("ORIGIN"):
                cur = []
            elif line.startswith("//"):
                if cur is not None:
                    seqs.append("".join(cur))
                cur = None
            elif cur is not None:
                cur.append("".join(ch for ch in line if ch.isalpha()))
    return seqs


def genbank_cds(path: str) -> List[Tuple[List[Tuple[int, int]], str]]:
    """(exons, strand) of the CDS feature of each GenBank record: 1-based
    inclusive (begin, end) pairs in ascending order."""
    out, cur = [], None
    with open(path) as fh:
        for line in fh:
            if line.startswith("     CDS "):
                cur = [line[21:].strip()]
            elif cur is not None and line.startswith(" " * 21) and \
                    not line[21:].lstrip().startswith("/"):
                cur.append(line[21:].strip())
            elif cur is not None:
                loc = "".join(cur)
                exons = [(int(a), int(b)) for a, b in
                         re.findall(r"(\d+)\.\.(\d+)", loc)]
                out.append((sorted(exons),
                            "-" if loc.startswith("complement") else "+"))
                cur = None
    return out


def golden_cds(path: str, seqname: str) -> List[Tuple[int, int]]:
    """The CDS exons of `seqname` in a GFF file (ascending, 1-based)."""
    exons = []
    with open(path) as fh:
        for line in fh:
            c = line.split("\t")
            if len(c) > 4 and c[0] == seqname and c[2] == "CDS":
                exons.append((int(c[3]), int(c[4])))
    return sorted(exons)


def parts(seq_dir: str = SEQ_DIR):
    """The genomic sequences in their fixed order: [(letters, [(exons,
    strand)])]."""
    out = []
    golden = os.path.join(seq_dir, "golden_human_mpe_hints.gff")
    for f in ("HS04636.fa", "HS08198.fa"):
        for name, seq in read_fasta(os.path.join(seq_dir, f)):
            out.append((seq, [(golden_cds(golden, name), "+")]))
    for f in ("genes_crf3.gb", "genes_test1.gb", "utrtrain.gb"):
        path = os.path.join(seq_dir, f)
        out += [(seq, [cds]) for seq, cds in
                zip(genbank_sequences(path), genbank_cds(path))]
    return out


def _hint_line(seqname, ftype, a, b, strand, group=""):
    grp = f"grp={group};" if group else ""
    return (f"{seqname}\tb2h\t{ftype}\t{a}\t{b}\t0\t{strand}\t.\t"
            f"{grp}pri=4;src=E\n")


def gene_hints(exons: List[Tuple[int, int]], strand: str, seqname: str,
               group: str, seqlen: int, rng: np.random.Generator,
               with_signals: bool) -> List[str]:
    """EST-style GFF hints (src=E, pri=4) of one gene structure, in one
    hint group, plus about 20 % of hints placed off the structure (a
    frozen copy of augustus_tpu_torch/io/tiled.py:gene_hints)."""
    lines: List[str] = []

    def add(ftype, a, b, st=strand, grp=group):
        if 1 <= a <= b <= seqlen:
            lines.append(_hint_line(seqname, ftype, a, b, st, grp))

    nex = len(exons)
    for i, (a, b) in enumerate(exons):
        ln = b - a + 1
        m = min(10, ln // 4)
        if ln >= 40 and i % 2 == 0:
            mid = (a + b) // 2
            add("exonpart", a + m, mid + 10)
            add("exonpart", mid - 10, b - m)
        elif ln >= 20:
            add("exonpart", a + m, b - m)
        if i % 3 == 1 and ln >= 30:
            add("CDSpart", a + m // 2 + 2, b - m // 2 - 2)
        if 0 < i < nex - 1 and i % 2 == 1:
            add("exon", a, b)
    a, b = max(exons, key=lambda e: e[1] - e[0])
    step = (b - a + 1) // 6
    if step >= 12:
        for k in range(5):
            add("exonpart", a + k * step + 4, a + (k + 1) * step - 4)
    for (_, b1), (a2, _) in zip(exons, exons[1:]):
        add("intron", b1 + 1, a2 - 1)
    add("CDS", *exons[nex // 2])
    add("exon", exons[0][0] - 40, exons[0][1])
    add("exon", exons[-1][0], exons[-1][1] + 40)
    if with_signals:
        lo, hi = exons[0][0], exons[-1][1]
        first, last = ((lo, hi - 2) if strand == "+" else (hi - 2, lo))
        add("start", first, first + 2)
        add("stop", last, last + 2)
        for (_, b1), (a2, _) in zip(exons, exons[1:]):
            dss, ass = (b1 + 1, a2 - 1) if strand == "+" else (a2 - 1, b1 + 1)
            add("dss", dss, dss)
            add("ass", ass, ass)
    for _ in range((len(lines) + 2) // 4):
        ftype = ("exonpart", "intron", "CDSpart")[int(rng.integers(0, 3))]
        a = int(rng.integers(1, seqlen - 300))
        add(ftype, a, a + int(rng.integers(30, 301)),
            st="+-"[int(rng.integers(0, 2))], grp="")
    return lines


def record_lengths(mix: dict, seed: int) -> List[int]:
    """The mix's set of record lengths, the same for every seed, in the
    seed's order."""
    spec = mix["lengths"]
    k = int(spec["count"])
    if "fixed" in spec:
        lengths = [int(spec["fixed"])] * k
    else:
        lo, hi = (float(x) for x in spec["loguniform"])
        q = (np.arange(k) + 0.5) / k
        lengths = [int(round(x)) for x in np.exp(np.log(lo)
                                                 + q * np.log(hi / lo))]
    rng = _rng(seed, 0)
    return [lengths[i] for _ in range(int(spec.get("sets", 1)))
            for i in rng.permutation(k)]


def make_record(mix: dict, seed: int, index: int, name: str, length: int,
                pool=None) -> Record:
    """One record of the mix: the sequences in turn from a seeded start,
    each after a seeded spacer, cut to `length`; upper case, with the
    mix's repeat runs in lower case and the hints of its inserted genes."""
    pool = parts() if pool is None else pool
    rng = _rng(seed, 1, index)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    slo, shi = mix["spacer"]
    out, layout, total = [], [], 0
    i = int(rng.integers(0, len(pool)))
    while total < length:
        spacer = acgt[rng.integers(0, 4, int(rng.integers(slo, shi + 1)))]
        out.append(spacer.tobytes().decode())
        seq, genes = pool[i % len(pool)]
        layout.append((total + len(out[-1]), seq, genes))
        out.append(seq.upper())
        total += len(out[-2]) + len(out[-1])
        i += 1
    letters = "".join(out)[:length]
    sm = mix.get("softmask")
    if sm:
        seq = bytearray(letters.encode())
        pos = int(rng.integers(sm["gap"][0], sm["gap"][1] + 1))
        while pos < length:
            end = min(pos + int(rng.integers(sm["run"][0], sm["run"][1] + 1)),
                      length)
            seq[pos:end] = seq[pos:end].lower()
            pos = end + int(rng.integers(sm["gap"][0], sm["gap"][1] + 1))
        letters = seq.decode()
    hints: List[str] = []
    hs = mix.get("hints")
    if hs:
        drop = set(hs.get("drop", ()))
        every = int(hs.get("signals_every", 2))
        for k, (off, part, genes) in enumerate(layout):
            for gi, (exons, strand) in enumerate(genes):
                lines = gene_hints(exons, strand, name, f"p{k}g{gi}",
                                   len(part), rng,
                                   with_signals=k % every == 0)
                for line in lines:
                    c = line.split("\t")
                    a, b = int(c[3]) + off, int(c[4]) + off
                    if b > length or c[2] in drop:
                        continue
                    c[3], c[4] = str(a), str(b)
                    hints.append("\t".join(c))
    return Record(name, letters, hints)


def make_records(mix: dict, seed: int, prefix: str = "r") -> List[Record]:
    """The mix's records for `seed`, named <prefix>1, <prefix>2, ..."""
    pool = parts()
    return [make_record(mix, seed, k, f"{prefix}{k + 1}", n, pool)
            for k, n in enumerate(record_lengths(mix, seed))]


def make_warmup(mix: dict, seed: int) -> Record:
    """The set-up's record: the mix's kind at its warm-up length, from a
    stream of the seed that no timed record uses."""
    return make_record(mix, seed, 1 << 31, "warmup",
                       int(mix["warmup"]["length"]))


def write_hints(records: List[Record], path: str) -> Optional[str]:
    """All records' hint lines in one GFF file, or None without hints."""
    lines = [h for r in records for h in r.hints]
    if not lines:
        return None
    with open(path, "w") as fh:
        fh.writelines(lines)
    return path
