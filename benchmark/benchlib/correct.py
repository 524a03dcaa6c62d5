"""How `correct` is decided: windows of the program's GFF against the
plain reference, and every printed gene against the record's letters.

After the measured window has closed, windows are drawn from the seed
over the records that the program finished: each begins where one of the
program's pieces begins, the record's first base or a cut point that its
exams chose (recorded from the timed run, `predict.cut_pieces`), and ends
past the first gene that the program printed in that piece, at least
`margin` bases from every printed gene and within `max` bases.  Half of
these windows, as far as the records give them, begin at cut points.  A
few more (`bare`) begin at pieces whose first printed gene lies farther
and reach `max` bases: the reference may find there a gene that the
program left out.  Only windows with a gene on either side count in the
number of windows compared.  The reference
(`reference.decode_window`) decodes each window in a pool of worker
processes on the CPU as the program decodes the piece's first bases: from
the piece's first base, in the synch (intergenic) state there unless it is
the record's first base, and ending in the synch state, where the
program's path lies.  Its float32 sums then run over the same positions
from the same start as the program's: a window that began inside a piece
would start its sums at 0 where the program's stand in the millions, and
near-ties between two gene structures would fall apart (an upstream exon
chosen 674 bases before the program's start codon, 1.2 Mb into a piece).
The program's genes in the window must equal the reference's line for
line: gene, transcript, CDS, codon lines and protein sequences.  The
numbers compared are how many lines differ (either side's lines missing
from the other), with the limit 0, and how many of the transcripts that
the program printed for the finished records, whole, break a rule of
`structure.py` (codons, splice sites, phases, translation), with the
limit 0.
"""

from __future__ import annotations

import bisect
import multiprocessing
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

LIMIT_LINES = 0
LIMIT_MALFORMED = 0


def limits(check_spec: dict) -> Dict[str, Tuple[str, int]]:
    """Each number compared, with its relation to its limit and the limit:
    the windows at cut points as the mix's check asks (`at_cuts`)."""
    return {"gff_lines_differing": ("<=", LIMIT_LINES),
            "transcripts_malformed": ("<=", LIMIT_MALFORMED),
            "windows": (">=", 1),
            "windows_at_cuts": (">=", int(check_spec.get("at_cuts", 0)))}


def passed(result: dict, check_spec: dict) -> bool:
    """Whether every number compared keeps to its limit."""
    for k, (rel, lim) in limits(check_spec).items():
        v = result[k]
        if (v > lim) if rel == "<=" else (v < lim):
            return False
    return True


def gene_blocks(text: str) -> List[Tuple[int, int, List[str]]]:
    """(begin, end, lines) of each gene of a GFF text: the lines from
    `# start gene` to `# end gene`, its extent from the gene line."""
    out, cur = [], None
    for line in text.splitlines():
        if line.startswith("# start gene"):
            cur = [line]
        elif cur is not None:
            cur.append(line)
            if line.startswith("# end gene"):
                ext = [c for c in (l.split("\t") for l in cur)
                       if len(c) >= 9 and c[2] == "gene"]
                out.append((int(ext[0][3]), int(ext[0][4]), cur))
                cur = None
    return out


def normalise(lines: List[str], shift: int) -> List[str]:
    """A gene block with its seqname `W`, its gene id `G` and the feature
    coordinates moved left by `shift`."""
    gid = lines[0].split()[-1]
    pat = re.compile(r"\b" + re.escape(gid) + r"\b")
    out = []
    for line in lines:
        c = line.split("\t")
        if len(c) >= 9 and not line.startswith("#"):
            c[0] = "W"
            c[3], c[4] = str(int(c[3]) - shift), str(int(c[4]) - shift)
            line = "\t".join(c)
        out.append(pat.sub("G", line))
    return out


def _forbidden(blocks, n: int, margin: int) -> List[Tuple[int, int]]:
    """Merged 1-based intervals where a window may not begin or end."""
    iv = sorted([(1, margin), (n - margin + 1, n)]
                + [(b - margin, e + margin) for b, e, _ in blocks])
    out: List[List[int]] = []
    for lo, hi in iv:
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(x) for x in out]


def _snap(x: int, forb: List[Tuple[int, int]]) -> int:
    """The first position at or after x outside every forbidden interval."""
    k = bisect.bisect_right(forb, (x, float("inf"))) - 1
    if k >= 0 and forb[k][0] <= x <= forb[k][1]:
        return forb[k][1] + 1
    return x


def _window_end(blocks, a: int, piece_end: int, n: int, check: dict,
                forb) -> Tuple[Optional[int], bool]:
    """(end, holds a gene) of the window that begins at a: past the first
    printed gene that begins at or after a where that gene ends within
    `max` bases and inside the piece, else as far as `max` bases reach
    inside the piece (a window with no printed gene, where the reference
    may find one); at least `margin` bases from every printed gene.  End
    None where no such window is `min` bases long."""
    margin, wmin, wmax = (int(check[k]) for k in ("margin", "min", "max"))
    last = min(a - 1 + wmax, piece_end, n - margin)
    first = [e for s, e, _ in blocks if s >= a]
    if first:
        b = _snap(max(a - 1 + wmin, min(first) + margin + 1), forb)
        if b <= last:
            return b, True
    k = bisect.bisect_right(forb, (last, float("inf"))) - 1
    b = forb[k][0] - 1 if k >= 0 and forb[k][0] <= last <= forb[k][1] \
        else last
    if b < a - 1 + wmin or any(a <= s and e <= b for s, e, _ in blocks):
        return None, False
    return b, False


def draw_windows(done: List[tuple], check: dict,
                 rng: np.random.Generator) -> List[Tuple[int, int, int]]:
    """Windows (record index, a, b; 1-based inclusive) drawn from rng.  Each
    begins at the first base of one of the program's pieces of a finished
    record (done[r][3]: its (begin, end) pieces, 0-based).  At most
    `windows` of them hold a gene that the program printed, those at cut
    points and those at records' first bases in turn while both last; at
    most `bare` more hold none (where a gene that the program left out
    would lie)."""
    margin = int(check["margin"])
    cand = {0: [], 1: [], "bare": []}
    for r, (_, n, text, pieces) in enumerate(done):
        blocks = gene_blocks(text)
        forb = _forbidden(blocks, n, margin)
        for k, (pb, pe) in enumerate(pieces):
            b, genic = _window_end(blocks, pb + 1, pe + 1, n, check, forb)
            if b is not None:
                cand[min(k, 1) if genic else "bare"].append((r, pb + 1, b))
    for k in cand:
        cand[k] = [cand[k][i] for i in rng.permutation(len(cand[k]))]
    out, turn = [], 1
    while len(out) < int(check["windows"]) and (cand[0] or cand[1]):
        if not cand[turn]:
            turn = 1 - turn
        out.append(cand[turn].pop(0))
        turn = 1 - turn
    return sorted(out + cand["bare"][:int(check.get("bare", 0))])


def program_lines(text: str, a: int, b: int) -> List[str]:
    """The program's gene lines inside [a, b], in window coordinates."""
    out = []
    for s, e, lines in gene_blocks(text):
        if a <= s and e <= b:
            out += normalise(lines, a - 1)
    return out


def reference_lines(lines: List[str]) -> List[str]:
    out = []
    for _, _, block in gene_blocks("\n".join(lines)):
        out += normalise(block, 0)
    return out


def differing(prog: List[str], ref: List[str]) -> int:
    """Lines of either side that the other lacks (as multisets)."""
    p, r = Counter(prog), Counter(ref)
    return sum(((p - r) + (r - p)).values())


def run_reference(jobs: List[dict], workers: int) -> List[List[str]]:
    """reference.decode_window of every job in a pool of spawned worker
    processes on the CPU, the longest first; every worker has ended when
    this returns."""
    from . import reference
    if not jobs:
        return []
    order = sorted(range(len(jobs)), key=lambda k: -len(jobs[k]["letters"]))
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(processes=max(1, min(workers, len(jobs))),
                    initializer=reference.init_worker)
    try:
        got = pool.map(reference.decode_window, [jobs[k] for k in order],
                       chunksize=1)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    out: List[Optional[List[str]]] = [None] * len(jobs)
    for k, lines in zip(order, got):
        out[k] = lines
    return out


def window_jobs(done: List[tuple], letters: List[str],
                check_spec: dict, seed: int, config_path: str,
                options: Dict[str, str], hints_path: Optional[str]):
    """The windows drawn from the seed over the finished records done =
    [(name, length, gff text, pieces)] and the reference's job for each."""
    from .generator import _rng
    wins = draw_windows(done, check_spec, _rng(seed, 2))
    jobs = [{"config_path": config_path, "options": options,
             "hints_path": hints_path, "name": done[r][0],
             "letters": letters[r][a - 1: b], "begin": a - 1,
             "control": None} for r, a, b in wins]
    return wins, jobs


def compare(done, wins, prog_side, ref_side) -> dict:
    """Lines differing between two sides of each window: a side is a list
    of GFF line lists, one per window, or None for the program's GFF."""
    per, genes, held = [], 0, []
    for k, (r, a, b) in enumerate(wins):
        sides = []
        for side in (prog_side, ref_side):
            if side is None:
                sides.append(program_lines(done[r][2], a, b))
            else:
                sides.append(reference_lines(side[k]))
        n_genes = [sum(1 for l in x if l.startswith("# start gene"))
                   for x in sides]
        genes += n_genes[0]
        held.append(max(n_genes) > 0)
        per.append(differing(*sides))
    return {"windows": sum(held),
            "windows_at_cuts": sum(1 for (_, a, _), h in zip(wins, held)
                                   if h and a > 1),
            "bases": sum(b - a + 1 for _, a, b in wins),
            "genes": genes, "gff_lines_differing": int(sum(per)),
            "per_window": [f"{a}-{b}:{d}" for (_, a, b), d in zip(wins, per)]}


def structure_check(done: List[tuple], letters: List[str]) -> dict:
    """structure.malformed over every finished record, whole."""
    from .structure import malformed
    n = bad = 0
    notes: List[str] = []
    for (name, _, text, _), seq in zip(done, letters):
        m, f, why = malformed(text, seq)
        n, bad = n + m, bad + f
        notes += [f"{name} {w}" for w in why][:5 - len(notes)]
    return {"transcripts": n, "transcripts_malformed": bad,
            "malformed": notes}


def workers() -> int:
    return max(1, min(len(os.sched_getaffinity(0)), 8))


def check(done: List[tuple], letters: List[str], check_spec,
          seed: int, config_path: str, options: Dict[str, str],
          hints_path: Optional[str]) -> dict:
    """Compare the program's GFF of the finished records done = [(name,
    length, gff text, pieces)] with the reference on windows drawn from
    the seed, and hold every printed transcript to the letters:
    {"windows", "windows_at_cuts", "bases", "genes",
    "gff_lines_differing", "per_window", "transcripts",
    "transcripts_malformed", "malformed"}."""
    wins, jobs = window_jobs(done, letters, check_spec, seed, config_path,
                             options, hints_path)
    out = compare(done, wins, None, run_reference(jobs, workers()))
    out.update(structure_check(done, letters))
    return out
