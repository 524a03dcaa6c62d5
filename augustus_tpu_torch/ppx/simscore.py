"""Profile-vs-protein similarity DP (reference src/pp_simscore.cc).

Global alignment of a protein sequence against a block profile with
inter-block distance constraints and optional intron-position scoring
(log10-odds terms weighted by intron_weight_*).  Scores match the
reference `pp_simScore` tool; the default output is the final similarity
score (S[last][0]).

The reference's quirks are preserved deliberately:
  * `(*seq)[len]` returns the NUL terminator -> amino-acid index -1 ->
    stop-codon score (pp_simscore.cc:128 allows n == len),
  * the gap-in-profile intron pseudo-frequency evaluates
    `epsi/epsi + epsi_no` = 1 + epsi_no (missing parentheses,
    pp_simscore.cc:369),
  * an [intron profile] section of a dropped (insignificant) block stays
    attached to the index its successor takes (pp_profile.cc:688 inserts
    before the drop decision).

Host copy of `augustus_tpu/ppx/simscore.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .profile import AA_INDEX, Profile

LOG_STOP = -1000.0 * math.log(2.0)          # Column::stopCodonScore (ln)
INTRON_INTRA_BFREQ = 1.706e-3               # pp_simscore.hh:279
INTRON_INTER_BFREQ = 9.599e-3               # pp_simscore.hh:285


class IntronProfile:
    """[intron profile] section (pp_profile.cc IntronProfile ctor)."""

    def __init__(self, lines: List[str]):
        self.intra: Dict[Tuple[int, int], int] = {}
        self.inter: Dict[int, int] = {}
        self.num_seq = 0
        for line in lines:
            if line.strip() == "":
                continue
            toks = line.split()
            nums = []
            for t in toks:
                try:
                    nums.append(float(t))
                except ValueError:
                    break
            if len(nums) >= 3:
                col, nucleo, freq = int(nums[0]), int(nums[1]), int(nums[2])
                self.intra[(col, nucleo)] = freq
            elif len(nums) == 2:
                self.inter[int(nums[0])] = int(nums[1])
            elif len(nums) == 1:
                self.num_seq = int(nums[0])

    def get_intra(self, c: int, f: int) -> int:
        return self.intra.get((c, f), 0)

    def get_inter(self, n: int) -> int:
        if not self.inter:
            return -1
        return self.inter.get(n, 0)


def parse_intron_profiles(prfl: Profile) -> Dict[int, IntronProfile]:
    """Collect the per-block intron profiles parsed into blk.iP lines."""
    out: Dict[int, IntronProfile] = {}
    for b, lines in prfl.iP_lines.items():
        out[b] = IntronProfile(lines)
    if getattr(prfl, "trailing_iP", None):
        out[len(prfl.blocks)] = IntronProfile(prfl.trailing_iP)
    return out


class ProteinSequence:
    """FASTA + optional intron-position section (pp_simscore.cc:87)."""

    def __init__(self, path: str):
        seq_lines: List[str] = []
        intron_lines: List[str] = []
        in_introns = False
        self.name = ""
        with open(path) as fh:
            for raw in fh:
                line = raw.rstrip("\n")
                if not in_introns:
                    if line.startswith("["):
                        in_introns = True
                        continue
                    if line.strip() == "":
                        continue
                    if line.startswith(">"):
                        self.name = line[1:].split()[0] if len(line) > 1 \
                            else ""
                    else:
                        seq_lines.append("".join(
                            c for c in line if not c.isspace()))
                else:
                    intron_lines.append(line)
        self.seq = "".join(seq_lines)
        self.len = len(self.seq)
        self.introns: Dict[int, int] = {}
        for line in intron_lines:
            toks = line.split()
            if len(toks) >= 2:
                try:
                    pos, frame = int(toks[0]), int(toks[1])
                except ValueError:
                    continue
                self.introns[pos] = frame
        # num_prev_introns[j] = #introns with position < j
        maxidx = max([self.len] + [p + 1 for p in self.introns])
        self.num_prev = np.zeros(maxidx + 1, dtype=np.int64)
        cnt = 0
        keys = sorted(self.introns)
        ki = 0
        for j in range(maxidx + 1):
            while ki < len(keys) and keys[ki] < j:
                cnt += 1
                ki += 1
            self.num_prev[j] = cnt

    def aa_index(self, n: int) -> int:
        if 0 <= n < self.len:
            return AA_INDEX.get(self.seq[n], -1)
        return -1           # includes the reference's NUL at n == len

    def intron_at(self, j: int) -> int:
        return self.introns.get(j, -1)

    def introns_in_range(self, start: int, end: int) -> int:
        if start < 0:
            start = 0
        if end < 0:
            end = 0
        return int(self.num_prev[end] - self.num_prev[start])


class SimilarityScore:
    """The pp_simScore DP (SimilarityScore::fillSimilarityMatrix)."""

    def __init__(self, gap_inter=-5.0, gap_intra=-50.0, gap_intron=-5.0,
                 intron_weight_intra=5.0, intron_weight_inter=5.0,
                 epsi_intron=1e-7, epsi_no_intron=0.1):
        self.g = gap_inter
        self.b = gap_intra
        self.g_i = gap_intron
        self.iw1 = intron_weight_intra
        self.iw2 = intron_weight_inter
        self.e_i = epsi_intron
        self.e_n = epsi_no_intron

    def read(self, seq_file: str, prfl_file: str) -> None:
        self.seq = ProteinSequence(seq_file)
        self.prfl = Profile(prfl_file)
        self.iP = parse_intron_profiles(self.prfl)
        self.num_prot = 0
        for b in sorted(self.iP):
            if self.iP[b].num_seq > 0:
                self.num_prot = self.iP[b].num_seq
                break

    # ---- intron score helpers ----------------------------------------
    @staticmethod
    def _poi(k: int, lam: float) -> float:
        return math.exp(k * math.log(lam) - lam - math.lgamma(k + 1))

    def _inter_score(self, q: float, q_b: float) -> float:
        return self.iw2 * (math.log10(q) - math.log10(q_b))

    def _inter_freq(self, b: int, n: int) -> int:
        ip = self.iP.get(b)
        return -1 if ip is None else ip.get_inter(n)

    def _intra_freq(self, b: int, c: int, f: int) -> int:
        ip = self.iP.get(b)
        return 0 if ip is None else ip.get_intra(c, f)

    def _intra_iscore(self, k: int, s: int, f: int,
                      intron_frame: int) -> float:
        freq = self._intra_freq(k, s, f)
        denom = self.num_prot + self.e_i + self.e_n
        if intron_frame == f:
            return self.iw1 * (math.log10((freq + self.e_i) / denom)
                               - math.log10(INTRON_INTRA_BFREQ))
        if intron_frame != -1 and freq > 0:
            return self.iw1 * (math.log10(1 - (freq + self.e_i) / denom)
                               - math.log10(1 - INTRON_INTRA_BFREQ))
        if freq > 0:
            return self.iw1 * math.log10(1 - (freq + self.e_i) / denom)
        return 0.0

    # ---- the DP -------------------------------------------------------
    def fill(self) -> None:
        seq, prfl = self.seq, self.prfl
        nb = prfl.block_count()
        min_len = sum(prfl.block_size(b) for b in range(nb))
        if seq.len < min_len:
            raise ValueError(
                f"pp_simscore: Input protein sequence too short "
                f"({seq.len} < {min_len})")
        row_length = seq.len - min_len + 1
        rows: List[np.ndarray] = []
        positions: List[int] = []

        # row 0
        r0 = np.zeros(seq.len + 1)
        for j in range(1, seq.len + 1):
            r0[j] = r0[j - 1] + self.g
            if seq.intron_at(j - 2) != -1:
                r0[j] += self.g_i
        rows.append(r0)
        positions.append(0)
        position = 1
        i = 0

        for t in range(nb):
            blk = prfl[t]
            d = blk.distance
            # ---- first column of block t -----------------------------
            prev = rows[i]
            cur = np.full(row_length, -math.inf)
            positions.append(position)
            i += 1
            prev_pos = positions[i - 1]
            for j in range(row_length):
                diff_pos = position - prev_pos + j
                if t == 0:
                    k_max = diff_pos + 1
                else:
                    k_max = min(row_length, diff_pos + 1)
                old = -math.inf
                logq = blk.logQ[0]
                aa = seq.aa_index(position + j - 1)
                match = logq[aa] if aa >= 0 else LOG_STOP
                for k in range(k_max):
                    iscore = 0.0
                    if self.iw2 > 0:
                        n_int = seq.introns_in_range(
                            prev_pos + k - 1, position + j - 1)
                        f_pos = self._inter_freq(t, n_int)
                        if n_int == 0 and f_pos < 0:
                            iscore = 0.0
                        else:
                            if f_pos < 0:
                                f_pos = 0
                            f_rel = (f_pos + self.e_i) / \
                                (self.num_prot + self.e_i + self.e_n)
                            ib_len = diff_pos - k
                            if t == 0 and j == 0:
                                ib_len -= 1
                            if ib_len < 1:
                                iscore = self._inter_score(f_rel, 1.0)
                            else:
                                lam = (d.min + d.max + 2) / 2.0 * \
                                    (INTRON_INTER_BFREQ / self.num_prot) \
                                    * 3 if self.num_prot else 1.0
                                iscore = self._inter_score(
                                    f_rel, self._poi(n_int, lam))
                    min_gaps = 0
                    if d.min - diff_pos + k + 1 > min_gaps:
                        min_gaps = d.min - diff_pos + k + 1
                    elif diff_pos - k - 1 - d.max > min_gaps:
                        min_gaps = diff_pos - k - 1 - d.max
                    if k == diff_pos:
                        new = prev[k] + self.g * min_gaps + self.b
                    else:
                        if self.g > match:
                            new = prev[k] + self.g * min_gaps + self.b
                        else:
                            new = prev[k] + self.g * min_gaps + match
                    if new + iscore > old:
                        old = new + iscore
                if j > 0:
                    frame = seq.intron_at(position + j - 2)
                    if frame < 0:
                        iscore = 0.0
                    else:
                        # reference precedence quirk: e/e + e_n = 1 + e_n
                        iscore = self._inter_score(
                            self.e_i / self.e_i + self.e_n,
                            3 * INTRON_INTRA_BFREQ)
                    new = cur[j - 1] + self.b + iscore
                    if new > old:
                        old = new
                cur[j] = old
            rows.append(cur)

            # ---- remaining columns of block t ------------------------
            for s in range(1, blk.size):
                position += 1
                i += 1
                positions.append(position)
                prev = rows[i - 1]
                cur = np.full(row_length, -math.inf)
                logq = blk.logQ[s]
                for j in range(row_length):
                    old = -math.inf
                    if j > 0:
                        new = cur[j - 1] + \
                            (self.g if s == blk.size - 1 else self.b)
                        if seq.intron_at(position + j - 2) != -1:
                            new += 3 * self.g_i
                        old = max(old, new)
                    if j < row_length - 1:
                        new = prev[j + 1] + self.b
                        for f in range(3):
                            new += self._intra_iscore(t, s - 1, f, -1)
                        if new > old:
                            old = new
                    aa = seq.aa_index(position + j - 1)
                    match = logq[aa] if aa >= 0 else LOG_STOP
                    new = prev[j] + match
                    frame = seq.intron_at(position + j - 2)
                    for f in range(3):
                        new += self._intra_iscore(t, s - 1, f, frame)
                    if new > old:
                        old = new
                    cur[j] = old
                rows.append(cur)
            position += 1

        # ---- final row ------------------------------------------------
        d = prfl.final_dist
        last = rows[i]
        last_pos = positions[i]
        diff_pos = seq.len - last_pos
        old = -math.inf
        for j in range(row_length):
            iscore = 0.0
            if self.iw2 > 0:
                n_int = seq.introns_in_range(last_pos + j - 1, seq.len - 1)
                f_pos = self._inter_freq(nb, n_int)
                if n_int == 0 and f_pos < 0:
                    iscore = 0.0
                else:
                    ib_len = diff_pos - j
                    if f_pos < 0:
                        f_pos = 0
                    f_rel = (f_pos + self.e_i) / \
                        (self.num_prot + self.e_i + self.e_n)
                    if ib_len < 1:
                        iscore = 0.0 if n_int == 0 else \
                            self._inter_score(f_rel, 1.0)
                    else:
                        lam = (d.min + d.max + 2) / 2.0 * \
                            (INTRON_INTER_BFREQ / self.num_prot) * 3 \
                            if self.num_prot else 1.0
                        iscore = self._inter_score(
                            f_rel, self._poi(n_int, lam))
            min_gaps = 0
            if d.min - diff_pos + j > min_gaps:
                min_gaps = d.min - diff_pos + j
            elif diff_pos - j - d.max > min_gaps:
                min_gaps = diff_pos - j - d.max
            new = last[j] + self.g * min_gaps + iscore
            if new > old:
                old = new
        self.final_score = old

    def score(self) -> float:
        return self.final_score
