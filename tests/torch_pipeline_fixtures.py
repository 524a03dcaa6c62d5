"""Seeded inputs of the pipeline and protein-profile tools, written by
plain Python and numpy (neither package is imported here), for the tests
of augustus_tpu_torch/pipeline and augustus_tpu_torch/ppx, for their
goldens (tests/torch_goldens.py, through tests/torch_pipeline.py) and for
chip_smoke.py's pipeline_hints, chunks, optimize and ppx phases.

Every input is a function of its seed (numpy's RandomState, whose stream
is fixed across numpy versions):
  write_bam        a BAM (gzip + struct, SAMv1 section 4.2) of 100-base
                   RNA-seq reads drawn along the genes of repo_fixture's
                   golden GFF of tests/data/HS04636.fa: spliced reads
                   across the introns, unspliced reads, noise reads over
                   the whole sequence and over a second reference
                   (HS08198), some soft- or hard-clipped, with an insertion,
                   a short deletion, a gap that drops the alignment, '='
                   and 'X' blocks, duplicate and reverse-strand flags
  psl_lines        the BAM's alignments as PSL lines
  write_small_gb   two GenBank records of at most 6 kb, cut by a
                   package's trainprep.gff2gb around one gene each
  write_metapars   a <species>_metapars.cfg
  write_ppx        a q_ij table, an MSA of a fixture gene's protein
                   (translated, mutated, with gappy linkers), its first
                   rows with a gap-riddled row added (prepareAlign's
                   input), the protein with its intron positions, and the
                   FASTA of HS04636.fa with its reverse complement
  add_intron_profiles  a .prfl with an [intron profile] section after
                   every block and after the final [dist]
"""

import gzip
import os
import struct

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN_GFF = os.path.join(ROOT, "augustus_tpu_torch", "data", "golden",
                          "repo_fixture_HS04636.gff")
BAM_SEED = 20150
PPX_SEED = 20151
READ_LEN = 100
CIGAR_OPS = "MIDNSHP=X"
# the standard genetic code, codons in TCAG order
_BASES = "TCAG"
_AA = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
AMINO = "ARNDCQEGHILKMFPSTWYV"


def read_fasta(path: str) -> dict:
    """{name: letters} of a FASTA file."""
    out, name = {}, None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                out[name] = []
            elif name is not None:
                out[name].append(line)
    return {k: "".join(v) for k, v in out.items()}


def golden_genes(path: str = GOLDEN_GFF) -> list:
    """[(seqname, strand, [(begin, end), ...])] of the CDS of every
    transcript in a GFF, 1-based and inclusive, in file order."""
    genes = {}
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if line.startswith("#") or len(f) < 9 or f[2] != "CDS":
                continue
            tid = f[8].split('transcript_id "')[1].split('"')[0]
            genes.setdefault(tid, (f[0], f[6], []))[2].append(
                (int(f[3]), int(f[4])))
    return [(s, st, sorted(ex)) for s, st, ex in genes.values()]


def revcomp(seq: str) -> str:
    return seq.translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))[::-1]


def translate(cds: str) -> str:
    out = []
    for i in range(0, len(cds) - 2, 3):
        c = cds[i:i + 3].upper()
        if any(b not in _BASES for b in c):
            out.append("X")
            continue
        out.append(_AA[16 * _BASES.index(c[0]) + 4 * _BASES.index(c[1])
                       + _BASES.index(c[2])])
    return "".join(out)


# ---- the BAM -----------------------------------------------------------

def _reg2bin(beg: int, end: int) -> int:
    """SAMv1 section 5.3 (end exclusive)."""
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


def _ref_span(cigar) -> int:
    return sum(n for n, op in cigar if op in "MDN=X")


def _query(cigar, seq: str, pos: int) -> str:
    """The read's letters: the reference under M/=/X, 'A' for inserted and
    soft-clipped bases, the reference's complement under X."""
    out, p = [], pos
    for n, op in cigar:
        if op in "M=":
            out.append(seq[p:p + n])
            p += n
        elif op == "X":
            out.append(revcomp(seq[p:p + n])[::-1])
            p += n
        elif op in "IS":
            out.append("A" * n)
        elif op in "DN":
            p += n
    return "".join(out).upper()


def _record(ref_id, pos, name, flag, cigar, query) -> bytes:
    packed = bytearray()
    codes = "=ACMGRSVTWYHKDBN"
    for i in range(0, len(query), 2):
        hi = codes.index(query[i]) if query[i] in codes else 15
        lo = (codes.index(query[i + 1]) if query[i + 1] in codes else 15) \
            if i + 1 < len(query) else 0
        packed.append(hi << 4 | lo)
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name) + 1, 60,
                       _reg2bin(pos, pos + max(_ref_span(cigar), 1)),
                       len(cigar), flag, len(query), -1, -1, 0)
    body += name.encode() + b"\0"
    body += b"".join(struct.pack("<I", n << 4 | CIGAR_OPS.index(op))
                     for n, op in cigar)
    body += bytes(packed) + b"\xff" * len(query)
    return struct.pack("<i", len(body)) + body


def _spliced(exons, t0: int, length: int):
    """(0-based start, cigar) of the read covering transcript bases
    [t0, t0 + length) of a gene with the 1-based exons `exons`."""
    cigar, start, left, t = [], None, length, 0
    prev_end = None
    for b, e in exons:
        size = e - b + 1
        if t + size <= t0:
            t += size
            prev_end = e
            continue
        lo = max(t0 - t, 0)
        take = min(size - lo, left)
        if start is None:
            start = b - 1 + lo
        elif prev_end is not None:
            cigar.append((b - prev_end - 1, "N"))
        cigar.append((take, "M"))
        left -= take
        t += size
        prev_end = e
        if not left:
            break
    return start, cigar


def _vary(cigar, rng):
    """A variant of a one-block alignment: clipped, with an insertion or a
    short deletion, as '='/'X' blocks, or with a gap that bam2hints drops
    (longer than maxgaplen, shorter than minintronlen)."""
    (n, _), = cigar
    kind = rng.randint(7)
    if kind == 0:
        return [(5, "S"), (n - 5, "M")]
    if kind == 1:
        return [(n - 4, "M"), (4, "H")]
    if kind == 2:
        return [(40, "M"), (1, "I"), (n - 41, "M")]
    if kind == 3:
        return [(50, "M"), (3, "D"), (n - 50, "M")]
    if kind == 4:
        return [(30, "="), (1, "X"), (n - 31, "=")]
    if kind == 5:
        return [(45, "M"), (20, "D"), (n - 45, "M")]
    return [(60, "M"), (10, "N"), (n - 60, "M")]


def bam_alignments(seed: int = BAM_SEED):
    """(ref_names, ref letters, [(ref_id, pos, name, flag, cigar)]) sorted
    by reference and position."""
    rng = np.random.RandomState(seed)
    seqs = read_fasta(os.path.join(DATA, "HS04636.fa"))
    seqs.update(read_fasta(os.path.join(DATA, "HS08198.fa")))
    names = ["HS04636", "HS08198"]
    als = []
    for seqname, _, exons in golden_genes():
        ref = names.index(seqname)
        tlen = sum(e - b + 1 for b, e in exons)
        spliced = len(exons) > 1
        for _ in range(240 if spliced else 60):
            t0 = int(rng.randint(0, tlen - READ_LEN + 1))
            pos, cigar = _spliced(exons, t0, READ_LEN)
            if len(cigar) == 1 and rng.rand() < 0.2:
                cigar = _vary(cigar, rng)
            als.append((ref, pos, cigar))
    for ref, count in ((0, 80), (1, 20)):
        n = len(seqs[names[ref]])
        for _ in range(count):
            pos = int(rng.randint(0, n - READ_LEN - 40))
            cigar = [(READ_LEN, "M")]
            if rng.rand() < 0.3:
                cigar = _vary(cigar, rng)
            als.append((ref, pos, cigar))
    als.sort(key=lambda a: (a[0], a[1]))
    out = []
    for i, (ref, pos, cigar) in enumerate(als):
        flag = 16 if rng.rand() < 0.5 else 0
        if rng.rand() < 0.03:
            flag |= 0x400
        out.append((ref, pos, f"read{i:04d}", flag, cigar))
    return names, [seqs[n] for n in names], out


def write_bam(path: str, seed: int = BAM_SEED) -> str:
    """The RNA-seq BAM of bam_alignments(seed), gzip-compressed (the
    readers take a plain gzip stream as BGZF); returns path."""
    names, letters, als = bam_alignments(seed)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{len(s)}\n" for n, s in zip(names, letters))
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text)) + text.encode()
    out += struct.pack("<i", len(names))
    for n, s in zip(names, letters):
        out += struct.pack("<i", len(n) + 1) + n.encode() + b"\0"
        out += struct.pack("<i", len(s))
    for ref, pos, name, flag, cigar in als:
        out += _record(ref, pos, name, flag, cigar,
                       _query(cigar, letters[ref], pos))
    with gzip.GzipFile(path, "wb", mtime=0) as fh:
        fh.write(bytes(out))
    return path


def psl_lines():
    """PSL lines of bam_alignments(): one block per M/=/X run."""
    names, letters, als = bam_alignments()
    out = []
    for ref, pos, name, _, cigar in als:
        sizes, qstarts, tstarts = [], [], []
        q, t = 0, pos
        for n, op in cigar:
            if op in "M=X":
                sizes.append(n)
                qstarts.append(q)
                tstarts.append(t)
                q += n
                t += n
            elif op in "IS":
                q += n
            elif op in "DN":
                t += n
        out.append("\t".join(map(str, [
            sum(sizes), 0, 0, 0, 0, 0, 0, 0, "+", name, q, 0, q,
            names[ref], len(letters[ref]), pos, t, len(sizes),
            ",".join(map(str, sizes)) + ",",
            ",".join(map(str, qstarts)) + ",",
            ",".join(map(str, tstarts)) + ","])) + "\n")
    return out


# ---- training sets and metaparameters ------------------------------------

# (GenBank set, record, flank): the 5,612-base third record of
# genes_crf3.gb and the 2,344-base HS08198 record of utrtrain.gb, each cut
# around its gene
SMALL_GB = (("genes_crf3.gb", "chr2L_115837-121448", 100),
            ("utrtrain.gb", "HS08198", 100))


def _gb_record(path: str, locus: str):
    """(letters, [(strand, [(begin, end)])]) of one GenBank record's CDS,
    1-based, read from its FEATURES and ORIGIN."""
    with open(path) as fh:
        text = fh.read()
    start = text.index("LOCUS       " + locus)
    rec = text[start:text.index("//\n", start)]
    origin = rec[rec.index("ORIGIN"):].splitlines()[1:]
    letters = "".join(c for line in origin for c in line if c.isalpha())
    genes = []
    lines = rec.splitlines()
    for i, line in enumerate(lines):
        if line[5:8] != "CDS":
            continue
        loc = line[21:].strip()
        j = i + 1
        while not loc.count("(") == loc.count(")") and j < len(lines):
            loc += lines[j].strip()
            j += 1
        strand = "-" if loc.startswith("complement") else "+"
        for tok in "complement join ( ) < >".split():
            loc = loc.replace(tok, " " if tok in "()" else "")
        exons = [tuple(int(v) for v in part.split(".."))
                 for part in loc.replace(" ", "").split(",")]
        genes.append((strand, exons))
    return letters, genes


def write_small_gb(dst_dir: str, gff2gb) -> str:
    """dst_dir/small.gb: the records of SMALL_GB cut by `gff2gb` (a
    package's pipeline.trainprep.gff2gb) from a FASTA and a GFF of their
    CDS; returns its path."""
    os.makedirs(dst_dir, exist_ok=True)
    texts = []
    for gb, locus, flank in SMALL_GB:
        letters, genes = _gb_record(os.path.join(DATA, gb), locus)
        fa = os.path.join(dst_dir, locus + ".fa")
        with open(fa, "w") as fh:
            fh.write(f">{locus}\n{letters}\n")
        gff = os.path.join(dst_dir, locus + ".gff")
        with open(gff, "w") as fh:
            for strand, exons in genes:
                for b, e in exons:
                    fh.write(f'{locus}\tgb\tCDS\t{b}\t{e}\t.\t{strand}\t0\t'
                             f'transcript_id "{locus}.t1";\n')
        texts.append(gff2gb(gff, fa, flank=flank))
    path = os.path.join(dst_dir, "small.gb")
    with open(path, "w") as fh:
        fh.write("".join(texts))
    return path


def write_metapars(path: str, pars) -> str:
    """A metapars file of (name, values) pairs, the values quoted."""
    with open(path, "w") as fh:
        fh.write("# metaparameters and their candidate values\n")
        for name, values in pars:
            fh.write(name + "  " + " ".join(f'"{v}"' for v in values) + "\n")
    return path


# ---- protein-profile inputs ----------------------------------------------

PPX_ROWS = 8
LINKERS = (40, 95, 150)       # protein positions before which linkers sit
LINKER_WIDTH = 6
# prepareAlign's input: the MSA's first rows and a gap-riddled one (with
# four rows, one gap takes a column below the block weight 0.8)
GAPPY_WITH = 3


def fixture_protein():
    """(protein without its stop, [(aa position, frame)] of its introns) of
    the multi-exon gene of repo_fixture's golden GFF of HS04636.fa."""
    seq = read_fasta(os.path.join(DATA, "HS04636.fa"))["HS04636"]
    _, strand, exons = next(g for g in golden_genes() if len(g[2]) > 1)
    assert strand == "+"
    cds, introns = "", []
    for b, e in exons:
        if cds:
            introns.append((len(cds) // 3, len(cds) % 3))
        cds += seq[b - 1:e]
    return translate(cds).rstrip("*"), introns


def _msa(protein: str, rng):
    """Rows of the MSA and, per column, the protein position of row 0 (None
    in a linker column)."""
    cols, where = [], []
    for i, aa in enumerate(protein):
        if i in LINKERS:
            for _ in range(LINKER_WIDTH):
                col = [AMINO[rng.randint(20)] if rng.rand() < 0.5 else "-"
                       for _ in range(PPX_ROWS)]
                col[rng.randint(PPX_ROWS)] = "-"
                col[rng.randint(PPX_ROWS)] = AMINO[rng.randint(20)]
                cols.append(col)
                where.append(None)
        col = [aa]
        for _ in range(1, PPX_ROWS):
            r = rng.rand()
            col.append("-" if r < 0.01 else
                       AMINO[rng.randint(20)] if r < 0.13 else aa)
        cols.append(col)
        where.append(i)
    rows = ["".join(c[r] for c in cols) for r in range(PPX_ROWS)]
    return rows, where


def _qij(rng) -> str:
    """A symmetric joint-probability table in BLOSUM's lower-triangular
    layout (order ARNDCQEGHILKMFPSTWYV)."""
    p = rng.dirichlet(np.full(20, 8.0))
    q = np.outer(p, p) * rng.uniform(0.5, 1.5, (20, 20))
    q = (q + q.T) / 2 + np.diag(p * rng.uniform(0.02, 0.06, 20))
    q /= q.sum()
    lines = ["# generated q_ij table", "   ".join(AMINO)]
    for i in range(20):
        lines.append(" ".join(f"{q[i, j]:.7f}" for j in range(i + 1)))
    return "\n".join(lines) + "\n"


def write_ppx(dst_dir: str, seed: int = PPX_SEED) -> dict:
    """The protein-profile inputs under dst_dir; returns their paths by
    name: qij, msa, msa_gappy (its first GAPPY_WITH rows and a
    gap-riddled copy of row 0), protein, genome (HS04636.fa and its reverse
    complement), and the MSA's column map (the protein position of row 0
    per column) under "where"."""
    rng = np.random.RandomState(seed)
    os.makedirs(dst_dir, exist_ok=True)
    protein, introns = fixture_protein()
    rows, where = _msa(protein, rng)
    out = {"where": where, "introns": introns}

    def write(name, text):
        out[name] = os.path.join(dst_dir, name)
        with open(out[name], "w") as fh:
            fh.write(text)

    write("default.qij", _qij(rng))
    out["qij"] = out.pop("default.qij")

    def fasta(names, seqs):
        return "".join(f">{n}\n" + "".join(
            s[i:i + 60] + "\n" for i in range(0, len(s), 60))
            for n, s in zip(names, seqs))

    names = [f"seq{r}" for r in range(PPX_ROWS)]
    write("msa.fa", fasta(names, rows))
    out["msa"] = out.pop("msa.fa")
    gappy = "".join(c if (c == "-" or rng.rand() > 0.6) else "-"
                    for c in rows[0])
    write("msa_gappy.fa", fasta(names[:GAPPY_WITH] + ["gappy"],
                                rows[:GAPPY_WITH] + [gappy]))
    out["msa_gappy"] = out.pop("msa_gappy.fa")
    write("protein.fa", f">fixture_protein\n{protein}\n[introns]\n" + "".join(
        f"{p} {f}\n" for p, f in introns))
    out["protein"] = out.pop("protein.fa")
    seq = read_fasta(os.path.join(DATA, "HS04636.fa"))["HS04636"]
    write("genome.fa", fasta(["HS04636", "HS04636_rc"], [seq, revcomp(seq)]))
    out["genome"] = out.pop("genome.fa")
    return out


def block_runs(rows, min_width: int = 6) -> list:
    """[(first column, width)] of the runs of gap-free upper-case columns
    of at least min_width (the blocks msa_to_prfl builds)."""
    runs, start = [], None
    width = len(rows[0])
    for c in range(width + 1):
        ok = c < width and all(r[c] not in ".-" and not r[c].islower()
                               for r in rows)
        if ok and start is None:
            start = c
        elif not ok and start is not None:
            if c - start >= min_width:
                runs.append((start, c - start))
            start = None
    return runs


def add_intron_profiles(prfl_text: str, rows, where, introns) -> str:
    """prfl_text with an [intron profile] section after each [block] and
    after the final [dist]: the number of sequences, the count of
    sequences with each number of introns in the region before the block
    (most with the protein's own count), and the (column, frame) of each
    intron of the protein inside the block."""
    runs = block_runs(rows)
    col_of = {p: c for c, p in enumerate(where) if p is not None}
    bounds = [0] + [s + w for s, w in runs]
    sections = []
    for b in range(len(runs) + 1):
        lo = bounds[b]
        hi = runs[b][0] if b < len(runs) else len(where)
        n_int = sum(lo <= col_of[p] < hi for p, _ in introns)
        lines = [str(PPX_ROWS), f"{n_int} {PPX_ROWS - 2}",
                 f"{(n_int + 1) % 3} 2"]
        if b < len(runs):
            s, w = runs[b]
            lines += [f"{col_of[p] - s} {f} {PPX_ROWS - 1}"
                      for p, f in introns if s <= col_of[p] < s + w]
        sections.append("\n[intron profile]\n" + "\n".join(lines) + "\n")
    parts = prfl_text.split("\n[dist]\n")
    out = parts[0]
    for b, part in enumerate(parts[1:]):
        if b > 0:
            out += sections[b - 1]
        out += "\n[dist]\n" + part
    return out.rstrip("\n") + "\n" + sections[-1]
