"""Training-set preparation.

Reference: scripts/gff2gbSmallDNA.pl (annotation GFF + genome FASTA ->
GenBank training files with per-gene flanking regions) and
scripts/randomSplit.pl (split a GenBank set into train/test).

Host copy of `augustus_tpu/pipeline/trainprep.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..io.fasta import read_fasta


def _revcomp(s: str) -> str:
    comp = str.maketrans("acgtACGTnN", "tgcaTGCAnN")
    return s.translate(comp)[::-1]


def _genbank_record(locus: str, seq: str, features: List[Tuple[str, str]]
                    ) -> str:
    """Minimal GenBank flat-file record in the layout the reference's
    GBProcessor (src/genbank.cc) and our io/genbank.py accept."""
    out = [f"LOCUS       {locus}   {len(seq)} bp  DNA"]
    out.append("FEATURES             Location/Qualifiers")
    for key, loc in features:
        out.append(f"     {key:<16}{loc}")
    out.append("ORIGIN")
    i = 0
    pos = 1
    low = seq.lower()
    while i < len(low):
        chunk = low[i:i + 60]
        groups = " ".join(chunk[j:j + 10] for j in range(0, len(chunk), 10))
        out.append(f"{pos:>9} {groups}")
        i += 60
        pos += 60
    out.append("//")
    return "\n".join(out) + "\n"


def _join_loc(parts: List[Tuple[int, int]], complement: bool) -> str:
    segs = [f"{b}..{e}" for (b, e) in parts]
    inner = segs[0] if len(segs) == 1 else "join(" + ",".join(segs) + ")"
    return f"complement({inner})" if complement else inner


def gff2gb(gff_path: str, fasta_path: str, flank: int = 1000,
           out=None) -> str:
    """GFF/GTF CDS annotation + genome -> GenBank training set
    (reference scripts/gff2gbSmallDNA.pl): one record per gene, cut with
    `flank` bases on both sides, CDS coordinates shifted accordingly."""
    genome = {r.name: r.sequence for r in read_fasta(fasta_path)}
    genes: Dict[str, dict] = {}
    for line in open(gff_path):
        if line.startswith("#") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 9 or f[2] != "CDS":
            continue
        tid = None
        attrs = f[8]
        if "transcript_id" in attrs:
            tid = attrs.split('transcript_id "')[1].split('"')[0]
        else:
            for tok in attrs.replace(";", " ").split():
                if tok.startswith("Parent="):
                    tid = tok[7:]
        if tid is None:
            tid = attrs.strip()
        g = genes.setdefault(tid, {"seq": f[0], "strand": f[6],
                                   "cds": []})
        g["cds"].append((int(f[3]), int(f[4])))
    chunks = []
    num = 0
    for tid, g in genes.items():
        if g["seq"] not in genome:
            continue
        seq = genome[g["seq"]]
        cds = sorted(g["cds"])
        lo = max(1, cds[0][0] - flank)
        hi = min(len(seq), cds[-1][1] + flank)
        sub = seq[lo - 1: hi]
        parts = [(b - lo + 1, e - lo + 1) for (b, e) in cds]
        num += 1
        locus = f"{g['seq']}.{num}"
        feats = [("source", f"1..{len(sub)}"),
                 ("CDS", _join_loc(parts, g["strand"] == "-"))]
        chunks.append(_genbank_record(locus, sub, feats))
    text = "".join(chunks)
    if out:
        open(out, "w").write(text)
    return text


def random_split(gb_path: str, test_size: int, seed: int = 1
                 ) -> Tuple[str, str]:
    """Split a GenBank flat file into .train/.test files (reference
    scripts/randomSplit.pl; writes <gb>.train and <gb>.test)."""
    import random
    recs = []
    cur: List[str] = []
    for line in open(gb_path):
        cur.append(line)
        if line.startswith("//"):
            recs.append("".join(cur))
            cur = []
    rng = random.Random(seed)
    idx = list(range(len(recs)))
    rng.shuffle(idx)
    test = set(idx[:test_size])
    train_p, test_p = gb_path + ".train", gb_path + ".test"
    with open(train_p, "w") as ftr, open(test_p, "w") as fte:
        for i, r in enumerate(recs):
            (fte if i in test else ftr).write(r)
    return train_p, test_p


def filter_genes(namefile: str, dbfile: str) -> str:
    """scripts/filterGenes.pl: drop GenBank records whose LOCUS name
    appears in namefile; returns the filtered flat-file text."""
    import re
    bad = set()
    with open(namefile) as fh:
        for line in fh:
            bad.add(line.rstrip("\n"))
    out = []
    with open(dbfile) as fh:
        record: list = []
        for line in fh:
            record.append(line)
            if line.rstrip() == "//":
                text = "".join(record)
                m = re.match(r"LOCUS +(\S+)", text)
                name = m.group(1) if m else ""
                if name not in bad:
                    out.append(text)
                record = []
        if record:
            text = "".join(record)
            m = re.match(r"LOCUS +(\S+)", text)
            if not m or m.group(1) not in bad:
                out.append(text)
    return "".join(out)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(
            "usage: python -m augustus_tpu_torch.pipeline.trainprep "
            "gff2gb anno.gff genome.fa flank out.gb\n"
            "       python -m augustus_tpu_torch.pipeline.trainprep "
            "randomsplit set.gb testsize\n")
        return 1
    if argv[0] == "gff2gb":
        gff2gb(argv[1], argv[2], int(argv[3]), argv[4])
        return 0
    if argv[0] == "randomsplit":
        tr, te = random_split(argv[1], int(argv[2]))
        print(tr)
        print(te)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
