"""msa2prfl — build a PPX block profile from a multiple sequence alignment.

Clean-room port of scripts/msa2prfl.pl: gap-free, all-uppercase MSA
columns form candidate blocks (runs shorter than --width=6 merge into
the surrounding inter-block region), per-sequence weights de-bias
redundant sequences (1/(residue multiplicity * distinct residues) per
column, averaged over the block), column frequencies are regularized
with BLOSUM q_ij pseudocounts (config/profile/default.qij; regularizer
weight 20/height), inter-block [dist] ranges come from the per-sequence
residue counts between blocks, and the [name]/[dist]/[block] sections
are printed in the format PP::Profile parses.

Host copy of `augustus_tpu/ppx/msa2prfl.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from .profile import AA_SYMBOLS

AA_LIST = list(AA_SYMBOLS)
AA_INDEX = {c: i for i, c in enumerate(AA_SYMBOLS)}
MIN_WIDTH = 6
GLOB_WEIGHT = 20.0
QIJ_ORDER = "ARNDCQEGHILKMFPSTWYV"   # classic BLOSUM file order
# ambiguity codes redistributed by background frequency (msa2prfl.pl:537)
AMBIG = {"U": ["C"], "B": ["D", "N"], "Z": ["E", "Q"], "O": ["K"],
         "J": ["I", "L"], "X": AA_LIST}


def read_qij(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(20,20) symmetric joint-probability matrix in PP aa order plus its
    marginals (msa2prfl.pl read_qij: symmetrize, normalize to sum 1)."""
    rows: List[List[float]] = []
    order: Optional[List[str]] = None
    for raw in open(path):
        line = raw.split("#")[0].strip()
        if not line:
            continue
        if order is None:
            letters = "".join(c for c in line.upper() if c.isalpha())
            if len(letters) == 20 and set(letters) == set(AA_SYMBOLS):
                order = list(letters)
                continue
            order = list(QIJ_ORDER)
        vals = [float(t) for t in line.split()]
        rows.append(vals)
        if len(rows) == 20:
            break
    if order is None:
        order = list(QIJ_ORDER)
    M = np.zeros((20, 20))
    for i, r in enumerate(rows):
        M[i, : len(r)] = r
    # symmetrize lower-triangular input
    M = np.where(M == 0.0, M.T, M)
    M = (M + M.T) / 2.0
    M /= M.sum()
    # reorder into PP amino-acid order
    perm = [order.index(a) for a in AA_LIST]
    M = M[np.ix_(perm, perm)]
    return M, M.sum(axis=1)


def read_msa(fh: TextIO) -> Tuple[List[str], List[str]]:
    """FASTA (or CLUSTAL-ish) MSA -> (names, equal-length rows)."""
    names: List[str] = []
    seqs: Dict[str, List[str]] = {}
    lines = [l.rstrip("\n") for l in fh]
    if lines and lines[0].upper().startswith("CLUSTAL"):
        for line in lines[1:]:
            if not line.strip() or line.startswith(" "):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            if parts[0] not in seqs:
                names.append(parts[0])
                seqs[parts[0]] = []
            seqs[parts[0]].append(parts[1])
    else:
        cur = None
        for line in lines:
            if line.startswith(">"):
                cur = line[1:].strip()
                names.append(cur)
                seqs[cur] = []
            elif cur is not None:
                seqs[cur].append("".join(
                    c for c in line if not c.isspace()))
    rows = ["".join(seqs[n]) for n in names]
    width = max((len(r) for r in rows), default=0)
    rows = [r + "-" * (width - len(r)) for r in rows]
    return names, rows


def default_qij_path() -> str:
    """The q_ij table msa_to_prfl reads when given none: the config tree's
    profile/default.qij under $AUGUSTUS_CONFIG_PATH (where the reference's
    msa2prfl.pl looks), else a default.qij beside this module.  The port
    ships no table: pass one, or set AUGUSTUS_CONFIG_PATH."""
    cfg = os.environ.get("AUGUSTUS_CONFIG_PATH")
    if cfg:
        path = os.path.join(cfg, "profile", "default.qij")
        if os.path.exists(path):
            return path
    return os.path.join(os.path.dirname(__file__), "default.qij")


def msa_to_prfl(rows: List[str], name: str = "profile",
                qij_path: Optional[str] = None,
                min_width: int = MIN_WIDTH) -> str:
    if qij_path is None:
        qij_path = default_qij_path()
    Q, Qmarg = read_qij(qij_path)
    height = len(rows)
    width = len(rows[0]) if rows else 0

    # ---- block columns (gap-free, uppercase) -------------------------
    blocks: List[dict] = []       # {cols: [colchars...], ibr: [...]}
    last_ibr: Optional[List[int]] = [0] * (height + 1)

    def merge_ibr(ibr: List[int], bl: dict) -> None:
        # reference merge_ibr (msa2prfl.pl:125): the dropped block's own
        # preceding inter-block counts AND its column count (block
        # columns are gap-free, so every sequence gains blw residues)
        blw = len(bl["cols"])
        for i in range(height + 1):
            ibr[i] += bl["ibr"][i] + blw

    for i in range(width):
        col = [r[i] for r in rows]
        gapcount = sum(1 for c in col if c in ".-")
        has_lower = any(c.islower() for c in col)
        if gapcount == 0 and not has_lower:
            if last_ibr is not None or not blocks:
                blocks.append({"cols": [col],
                               "ibr": last_ibr or [0] * (height + 1)})
                last_ibr = None
            else:
                blocks[-1]["cols"].append(col)
        elif gapcount < height:
            if last_ibr is None:
                last_ibr = [0] * (height + 1)
                if blocks and len(blocks[-1]["cols"]) < min_width:
                    merge_ibr(last_ibr, blocks.pop())
            for s in range(height):
                if col[s] not in ".-":
                    last_ibr[s] += 1
            last_ibr[height] += 1
        # all-gap columns are skipped entirely

    if last_ibr is None:
        last_ibr = [0] * (height + 1)
        if blocks and len(blocks[-1]["cols"]) < min_width:
            merge_ibr(last_ibr, blocks.pop())
    blocks.append({"cols": [], "ibr": last_ibr})
    # drop any remaining too-short blocks, merging into the NEXT ibr
    i = 0
    while i < len(blocks) - 1:
        if 0 < len(blocks[i]["cols"]) < min_width:
            merge_ibr(blocks[i + 1]["ibr"], blocks[i])
            del blocks[i]
        else:
            i += 1

    # ---- [dist] ranges ------------------------------------------------
    dists = []
    for bl in blocks:
        per_seq = bl["ibr"][:height]
        dists.append((min(per_seq, default=0),
                      max(per_seq, default=0)))

    # ---- per-block sequence weights + column frequencies ---------------
    out: List[str] = ["[name]", name]
    blcount = 0
    suffices = [chr(ord("A") + i) for i in range(26)] + \
        [a + b for a in map(chr, range(65, 91))
         for b in map(chr, range(65, 91))]
    for bi, bl in enumerate(blocks):
        lo, hi = dists[bi]
        out.append("")
        out.append("[dist]")
        out.append("# distance from previous block")
        out.append("# <min> <max>")
        out.append(f"{lo}\t{hi}")
        cols = bl["cols"]
        if not cols:
            continue
        blw = len(cols)
        # weights (msa2prfl.pl:470): per column, residue c contributes
        # 1/(count(c) * #distinct residues); averaged over the block
        weights = np.zeros(height)
        for col in cols:
            counts: Dict[str, int] = {}
            for c in col:
                counts[c] = counts.get(c, 0) + 1
            res = [c for c in counts if c in AA_INDEX]
            nres = len(res)
            cw = {c: (1.0 / counts[c] / nres if c in AA_INDEX and nres
                      else 0.0) for c in counts}
            for s, c in enumerate(col):
                weights[s] += cw.get(c, 0.0)
        weights /= blw

        out.append("")
        out.append("[block]")
        out.append(f"# block no. {blcount} follows, {height} sequences,"
                   f" length {blw}")
        out.append(f"name={name}_{suffices[blcount]}")
        out.append("#")
        out.append(f"# <colnr> <probs for {AA_SYMBOLS}>")
        out.append("#\t" + "\t".join(AA_LIST))
        blcount += 1
        regweight = GLOB_WEIGHT / height
        for ci, col in enumerate(cols):
            freq = np.zeros(20)
            extra: Dict[str, float] = {}
            for s, c in enumerate(col):
                if c in AA_INDEX:
                    freq[AA_INDEX[c]] += weights[s]
                else:
                    extra[c.upper()] = extra.get(c.upper(), 0.0) + \
                        weights[s]
            # redistribute ambiguity codes by background marginals
            for code, targets in AMBIG.items():
                if code in extra:
                    w = extra.pop(code)
                    tf = np.array([Qmarg[AA_INDEX[t]] for t in targets])
                    tf = tf / tf.sum()
                    for t, f in zip(targets, tf):
                        freq[AA_INDEX[t]] += w * f
            total = freq.sum() + sum(extra.values())
            if total > 0:
                freq = freq / total
            # BLOSUM regularization (pseudocounts)
            reg = (freq / Qmarg) @ Q
            freq = (freq + regweight * reg) / (1 + regweight)
            vals = []
            for v in freq:
                vals.append(f"{v:.2g}" if v < 1e-4 else f"{v:7.5f}")
            out.append(f"{ci}\t" + "\t".join(vals))
    out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = "profile"
    qij = None
    min_width = MIN_WIDTH
    path = None
    for a in argv:
        if a.startswith("--name="):
            name = a.split("=", 1)[1]
        elif a.startswith("--qij="):
            qij = a.split("=", 1)[1]
        elif a.startswith("--width="):
            min_width = int(a.split("=", 1)[1])
        elif not a.startswith("--"):
            path = a
    fh = open(path) if path else sys.stdin
    _, rows = read_msa(fh)
    if not rows:
        sys.stderr.write("msa2prfl: empty alignment\n")
        return 1
    sys.stdout.write(msa_to_prfl(rows, name=name, qij_path=qij,
                                 min_width=min_width))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
