"""Protein block profiles (.prfl) — parser, scoring, thresholds.

Mirrors reference src/pp_profile.cc / include/pp_profile.hh: columns of
amino-acid distributions in the fixed order GDERKNQSTAVLIFYWHMCP
(src/geneticcode.cc:14), odds ratios against the background composition
(pp_profile.cc:25), per-block score distributions (mean/variance of
log-odds under background and under the block model), the partial-score
threshold matrix (Block::initThresholds, pp_profile.cc:245) and the
block acceptance threshold.  All scores live in natural-log space here
(the reference's LLDouble products become float64 log sums).

Host copy of `augustus_tpu/ppx/profile.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import math
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_AA = 20
AA_SYMBOLS = "GDERKNQSTAVLIFYWHMCP"          # geneticcode.cc:14 (sans '*')
AA_INDEX = {c: i for i, c in enumerate(AA_SYMBOLS)}

# pp_profile.cc:25 default_amino_frq
_DEFAULT_AMINO_FRQ = np.array([
    0.07088, 0.05268, 0.06270, 0.05256, 0.05807,
    0.04439, 0.04037, 0.07068, 0.05837, 0.07689,
    0.06538, 0.09200, 0.05527, 0.03995, 0.03224,
    0.01312, 0.02253, 0.02353, 0.01793, 0.05046])

MIN_FREQ = 0.0001                            # pp_profile.cc:35
# the background is itself a Column, so it passes through the same
# normalize-and-floor transform (Column::operator=, pp_profile.cc:52)
BACKGROUND = (_DEFAULT_AMINO_FRQ / _DEFAULT_AMINO_FRQ.sum()) \
    * (1 - MIN_FREQ * 20) + MIN_FREQ
LOG2 = math.log(2.0)
LOG_STOP = -1000.0 * LOG2                    # Column::stopCodonScore
LOG_ALMOST_ZERO = -500.0 * LOG2              # Block::almostZero
MIN_CHECKCOUNT = 3                           # pp_profile.hh:41
MIN_BLOCKSIZE = 6                            # pp_profile.hh:42
MAX_BLOCKCOUNT = 64
MAXINTERBLOCKDIST = (1 << 15) - 1
RELAXATION = 0.05

# default threshold quantiles (pp_profile.hh:45-52), overridable via
# /ProteinModel/* properties (PP::initConstants, pp_profile.cc)
DEFAULTS = {
    "min_spec": 4.0, "min_sens": 0.4,
    "partial_spec": 4.5, "partial_sens": 2.0,
    "global_thresh": 2.5, "absolute_malus_threshold": 0.0,
    "weight": 1.0,
}


@dataclass
class Dist:
    """Mean/variance pair of a score distribution (pp_profile.hh:55)."""
    mu: float = 0.0
    var: float = 0.0

    def __add__(self, o: "Dist") -> "Dist":
        return Dist(self.mu + o.mu, self.var + o.var)

    def __sub__(self, o: "Dist") -> "Dist":
        return Dist(self.mu - o.mu, self.var - o.var)

    def stddev(self) -> float:
        return math.sqrt(self.var if self.var >= 0 else -self.var)

    def normed(self, absval: float) -> float:
        return (absval - self.mu) / self.stddev()

    def abs(self, normed: float) -> float:
        return normed * self.stddev() + self.mu


@dataclass
class DistanceType:
    """Inter-block distance range (pp_profile.hh:227)."""
    min: int = 0
    max: int = 0
    has_max: bool = True

    def __iadd__(self, o: "DistanceType") -> "DistanceType":
        self.min += o.min
        self.max += o.max
        self.has_max = self.has_max and o.has_max
        return self

    def set_inf_max(self) -> None:
        self.max = self.min
        self.has_max = False

    def make_tolerant(self) -> None:
        self.min = int(self.min * (1 - RELAXATION) + 0.5)
        if self.has_max:
            self.max = int(self.max * (1 + RELAXATION) + 0.5)
            if self.max >= MAXINTERBLOCKDIST:
                self.set_inf_max()

    def has(self, elem: int) -> bool:
        return (self.min <= elem <= self.max) if self.has_max \
            else self.min <= elem


def _parse_dist(text: str) -> DistanceType:
    toks = text.split()
    d = DistanceType()
    d.min = int(toks[0])
    if toks[1] == "*":
        d.has_max = False
        d.max = d.min
    else:
        d.max = int(toks[1])
    return d


class Block:
    """One profile block: (size, 20) column distributions + thresholds."""

    def __init__(self, distance: DistanceType, lines: List[str],
                 default_id: str, weight: float = 1.0):
        self.id = default_id
        self.distance = distance
        self.iP = None                       # intron profile (optional)
        cols: List[np.ndarray] = []
        for line in lines:
            if line.startswith("name="):
                self.id = line[5:]
                continue
            if line.strip() == "":
                continue
            toks = line.split()
            n = int(toks[0])
            if n != len(cols) or len(toks) != NUM_AA + 1:
                raise ValueError(f"bad block column line: {line!r}")
            vals = np.array([float(t) for t in toks[1:]])
            if (vals < 0).any() or vals.sum() <= 0:
                raise ValueError("bad column values")
            cols.append(vals / vals.sum() * (1 - MIN_FREQ * NUM_AA)
                        + MIN_FREQ)
        self.values = np.array(cols)                      # (size, 20)
        self.weight = weight
        # odds ratios (Column::initRatios)
        self.logQ = weight * (np.log(self.values) - np.log(BACKGROUND))
        self.size = self.values.shape[0]

    # Column::getDist vectorized over columns: returns (mu, var) arrays
    def _col_dists(self, model: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mu_a = model * self.logQ                          # (size, 20)
        mu = mu_a.sum(axis=1)
        var = (mu_a * self.logQ).sum(axis=1) - mu * mu
        return mu, var

    def init_distributions(self) -> None:
        """Block::initDistributions: suffix cumulative dists."""
        mu_o, var_o = self._col_dists(self.values)
        mu_b, var_b = self._col_dists(np.broadcast_to(BACKGROUND,
                                                      self.values.shape))
        self.own_dists = [Dist()] * 0
        self.own_dists = [Dist(0.0, 0.0) for _ in range(self.size + 1)]
        self.back_dists = [Dist(0.0, 0.0) for _ in range(self.size + 1)]
        for i in range(self.size - 1, -1, -1):
            self.own_dists[i] = self.own_dists[i + 1] + \
                Dist(float(mu_o[i]), float(var_o[i]))
            self.back_dists[i] = self.back_dists[i + 1] + \
                Dist(float(mu_b[i]), float(var_b[i]))

    def own_dist(self, frm: int = 0, to: Optional[int] = None) -> Dist:
        if to is None:
            return self.own_dists[frm]
        return self.own_dists[frm] - self.own_dists[to]

    def back_dist(self, frm: int = 0, to: Optional[int] = None) -> Dist:
        if to is None:
            return self.back_dists[frm]
        return self.back_dists[frm] - self.back_dists[to]

    def sens_thresh(self, sd: float, frm: int = 0,
                    to: Optional[int] = None) -> float:
        return self.own_dist(frm, to).abs(-sd)

    def spec_thresh(self, sd: float, frm: int = 0,
                    to: Optional[int] = None) -> float:
        return self.back_dist(frm, to).abs(sd)

    def init_thresholds(self, consts: Dict[str, float]) -> bool:
        """Block::initThresholds (log-space threshold matrix).  False if
        the block is statistically insignificant (then it is dropped)."""
        if self.size < MIN_BLOCKSIZE:
            return False
        ps, pn = consts["partial_spec"], consts["partial_sens"]
        M: List[List[float]] = []
        for to in range(self.size + 1):
            row: List[float] = []
            for frm in range(0, to - MIN_CHECKCOUNT + 1):
                min_lt = self.spec_thresh(ps, frm, to)
                lt = self.sens_thresh(pn, frm, to)
                if min_lt <= lt:
                    lt = (min_lt + lt) / 2
                row.append(lt)
            if to == self.size:
                while len(row) < self.size + 1:
                    row.append(LOG_ALMOST_ZERO)
            else:
                if to < MIN_CHECKCOUNT:
                    row.append(LOG_ALMOST_ZERO)
                while len(row) < to + 1:
                    row.append(math.inf)
            M.append(row)
        self.threshold_matrix = M
        sens = self.sens_thresh(consts["min_sens"])
        spec = self.spec_thresh(consts["min_spec"])
        if spec <= sens:
            self.log_threshold = (spec + sens) / 2
            return True
        return False

    def partial_thresh(self, complement: bool, frm: int, to: int) -> float:
        if complement:
            return self.threshold_matrix[self.size - frm][self.size - to]
        return self.threshold_matrix[to][frm]

    def is_anchor(self, consts: Dict[str, float]) -> bool:
        return self.log_threshold > self.spec_thresh(
            consts.get("min_anchor_spec", 4.0))

    def best_partial_log_score(self, complement: bool, aa_idx: np.ndarray
                               ) -> Tuple[float, int, int]:
        """Block::bestPartialLogScore (pp_profile.cc): best-scoring run of
        consecutive columns (Kadane in log space).  aa_idx: (size,) amino
        acid indices aligned to columns (already reversed/complemented by
        the caller for the reverse strand); -1 = stop codon / invalid.

        Returns (score, from, to); score 0 with from=to=0 when below the
        partial and full-block thresholds."""
        q = np.where(aa_idx >= 0,
                     self.logQ[np.arange(self.size),
                               np.clip(aa_idx, 0, NUM_AA - 1)],
                     LOG_STOP)
        frm = 0
        locmax = 0.0
        globmax = 0.0
        rf = rt = 0
        for t in range(self.size):
            locmax += q[t]
            if locmax < 0.0:
                locmax = 0.0
                frm = t + 1
            if globmax < locmax:
                globmax = locmax
                rf, rt = frm, t + 1
        if globmax >= self.partial_thresh(complement, rf, rt) or \
                globmax >= self.log_threshold:
            return globmax, rf, rt
        return 0.0, 0, 0


class Profile:
    """A parsed .prfl profile (PP::Profile, pp_profile.cc:652)."""

    def __init__(self, path: str, consts: Optional[Dict[str, float]] = None):
        self.consts = dict(DEFAULTS)
        if consts:
            self.consts.update(consts)
        self.name = ""
        self.blocks: List[Block] = []
        self.final_dist = DistanceType()
        # [intron profile] sections keyed the reference way: the index the
        # block had when pushed (pp_profile.cc:688 inserts BEFORE the
        # significance check, so a dropped block's profile stays attached
        # to the index its successor takes)
        self.iP_lines: Dict[int, List[str]] = {}
        self.trailing_iP: Optional[List[str]] = None
        self._parse(path)
        if not self.blocks:
            raise ValueError(f"No usable blocks found in file \"{path}\"")
        if len(self.blocks) > MAX_BLOCKCOUNT:
            raise ValueError(f"More than {MAX_BLOCKCOUNT} blocks")
        if not self.name:
            base = path.rsplit("/", 1)[-1]
            self.name = base.rsplit(".", 1)[0]

    # ---- parsing ------------------------------------------------------
    def _sections(self, path: str):
        """Yield (type, lines) with comments stripped (readPart)."""
        cur_type = ""
        cur: List[str] = []
        with open(path) as fh:
            for raw in fh:
                line = raw.split("#")[0].rstrip("\t\n\v\f\r ")
                if line.startswith("["):
                    yield cur_type, cur
                    cur_type, cur = line, []
                else:
                    cur.append(line)
        yield cur_type, cur

    def _parse(self, path: str) -> None:
        sec = list(self._sections(path))
        i = 0
        # ignore any leading text before the first section
        if sec and sec[0][0] == "":
            i = 1
        if i < len(sec) and sec[i][0] == "[name]":
            body = [l for l in sec[i][1] if l.strip()]
            self.name = body[0] if body else ""
            i += 1
        block_name = ord("A")
        block_numb = 0
        final = DistanceType()
        while i < len(sec):
            typ, lines = sec[i]
            if typ == "[dist]":
                body = " ".join(l for l in lines if l.strip())
                final += _parse_dist(body)
                i += 1
                if i >= len(sec):
                    break
                typ, lines = sec[i]
            else:
                final.set_inf_max()
            if typ != "[block]":
                break
            blk = Block(final, lines, "block_" + chr(block_name),
                        weight=self.consts["weight"])
            block_name += 1
            blk.block_numb_in_file = block_numb
            block_numb += 1
            i += 1
            if i < len(sec) and sec[i][0] == "[intron profile]":
                self.iP_lines[len(self.blocks)] = \
                    [l for l in sec[i][1] if l.strip()]
                i += 1
            blk.init_distributions()
            if not blk.init_thresholds(self.consts):
                sys.stderr.write(
                    f"Warning: Block no.{blk.id} is not significant "
                    "enough, removed from profile.\n")
                final.min += blk.size
                final.max += blk.size
            else:
                blk.distance.make_tolerant()
                final = DistanceType()
                self.blocks.append(blk)
        if i < len(sec) and sec[i][0] == "[intron profile]":
            self.trailing_iP = [l for l in sec[i][1] if l.strip()]
        self.final_dist = final
        self._calc_global_thresh()
        self.final_dist.make_tolerant()

    # ---- global thresholds (Profile::calcGlobalThresh) ----------------
    def _calc_global_thresh(self) -> None:
        gt = self.consts["global_thresh"]
        amt = self.consts["absolute_malus_threshold"]
        log_amt = math.log(amt) if amt > 0 else -math.inf
        nb = len(self.blocks)
        self.global_thresh = [[None] * nb, [None] * nb]
        tail = Dist()
        full = Dist()
        for b in self.blocks:
            full = full + b.own_dist(0)
        for bi in range(nb - 1, -1, -1):
            blk = self.blocks[bi]
            cur = [0.0] * (blk.size + 1)
            cur_rev = [0.0] * (blk.size + 1)
            for i in range(blk.size + 1):
                d = tail + blk.own_dist(i)
                d_rev = full - d
                cur[i] = max(-d.abs(gt), log_amt)
                cur_rev[blk.size - i] = max(-d_rev.abs(gt), log_amt)
            self.global_thresh[0][bi] = cur
            self.global_thresh[1][nb - 1 - bi] = cur_rev
            tail = tail + blk.own_dist(0)

    # ---- convenience --------------------------------------------------
    def block_count(self) -> int:
        return len(self.blocks)

    def block_size(self, b: int) -> int:
        return self.blocks[b].size

    def __getitem__(self, b: int) -> Block:
        return self.blocks[b]
