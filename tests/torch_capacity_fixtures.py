"""Seeded inputs past the kernels' capacity, written by plain Python and
numpy (neither package is imported here), for tests/test_torch_capacity.py,
its goldens (tests/torch_goldens.py) and chip_smoke.py's capacity cell.

  write_capacity   the first LENGTH bases of tests/data/HS04636sm.fa and
                   one exonpart hint per aligned block of a 100-base
                   RNA-seq read drawn along the hinted golden gene's exons
                   (tests/torch_pipeline_fixtures.py's read generator,
                   unjoined: every read is a hint group of its own, so
                   the hints stack as deep as the coverage)
  capacity_run     its arguments (softmasked, EST-hinted) and FASTA path

Every input is a function of its seed (numpy's RandomState, whose stream
is fixed across numpy versions).
"""

import os

import numpy as np

from torch_pipeline_fixtures import DATA, ROOT, READ_LEN, _spliced, \
    golden_genes, read_fasta

HINTED_GOLDEN = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                             "repo_fixture_HS04636sm_hints.gff")
LENGTH = 1200
CAPACITY_SEED = 20160
# reads of each depth (every read covers the exon's middle, so the depth
# is the count): "slots" passes K1's 64 crossing slots; "deep" passes what
# K2's staged rows and descriptor hold in shared memory for 47 and for 71
# states, which the deep layout takes (engine/scan.py:_descriptor)
DEPTHS = {"slots": 70, "deep": 1300}
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
# the capacity runs: softmasked, EST-hinted, one per species
SPECIES = {"repo_fixture": {"UTR": "off"},
           "repo_fixture_utr": {"UTR": "on", "print_utr": "on"}}


def capacity_reads(reads: int, seed: int = CAPACITY_SEED, length=LENGTH):
    """[(start, end)] 1-based inclusive aligned blocks of `reads` reads
    drawn uniformly along the hinted golden gene's exons inside the first
    `length` bases, in read order."""
    rng = np.random.RandomState(seed)
    (_, _, exons), = golden_genes(HINTED_GOLDEN)
    exons = [(b, e) for b, e in exons if e <= length]
    tlen = sum(e - b + 1 for b, e in exons)
    out = []
    for i in range(reads):
        t0 = int(rng.randint(0, tlen - READ_LEN + 1))
        pos, cigar = _spliced(exons, t0, READ_LEN)
        at = pos + 1
        for n, op in cigar:
            if op == "M":
                out.append((i, at, at + n - 1))
            at += n
    return out


def write_capacity(dst_dir: str, which: str = "slots",
                   seed: int = CAPACITY_SEED) -> dict:
    """{"fasta", "hints"} paths of the capacity input `which` (DEPTHS)."""
    os.makedirs(dst_dir, exist_ok=True)
    name, seq = next(iter(read_fasta(os.path.join(DATA,
                                                  "HS04636sm.fa")).items()))
    fasta = os.path.join(dst_dir, f"capacity_{which}.fa")
    with open(fasta, "w") as fh:
        fh.write(f">{name}\n")
        s = seq[:LENGTH]
        for i in range(0, len(s), 60):
            fh.write(s[i: i + 60] + "\n")
    hints = os.path.join(dst_dir, f"capacity_{which}.gff")
    with open(hints, "w") as fh:
        for i, b, e in capacity_reads(DEPTHS[which], seed):
            fh.write(f"{name}\tb2h\texonpart\t{b}\t{e}\t0\t+\t.\t"
                     f"grp=read{i:05d};pri=4;src=E\n")
    return {"fasta": fasta, "hints": hints}


def capacity_run(which: str, dst_dir: str, species: str = "repo_fixture"):
    """(arguments, FASTA path) of the capacity input `which` on `species`,
    its files written into dst_dir."""
    p = write_capacity(dst_dir, which)
    args = {"species": species, "AUGUSTUS_CONFIG_PATH": CONFIG,
            "softmasking": "1", "hintsfile": p["hints"],
            "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"}
    args.update(SPECIES[species])
    return args, p["fasta"]


def max_depth(blocks) -> int:
    """The most blocks that cover one base."""
    if not blocks:
        return 0
    hi = max(e for _, _, e in blocks)
    a = np.zeros(hi + 2, np.int64)
    for _, b, e in blocks:
        a[b] += 1
        a[e + 1] -= 1
    return int(np.cumsum(a).max())
