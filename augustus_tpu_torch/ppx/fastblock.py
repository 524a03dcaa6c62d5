"""Fast profile-block pre-filter (reference fastBlockSearch).

Clean-room, vectorized re-implementation of src/pp_fastBlockSearcher.hh +
src/fastBlockSearch.cc: find genomic locations where profile blocks hit,
chain nearby block hits into profile hit groups, and report groups above
a cutoff.  The reference walks the sequence position-by-position pushing
amino-acid 3-mer "seeds" into per-block candidate queues; here the seed
events are generated for the whole sequence with NumPy (translated 3-mer
ids -> CSR seed table lookup) and accumulated per candidate block start
with segmented reductions — same counts, same hits, same output.

Pipeline (mirroring the reference):
  1. Seed collection (FsSeedCollection): per block b and offset i the
     top-scoring aa 3-mers by odds ratio, limited to 10000/blocksize
     seeds per offset or 80% coverage (pp_fastBlockSearcher.cc:15-16).
  2. Candidate counting (CandidateCollection): a candidate is (block,
     strand, DNA start); each seed event adds min(|i - last_i|, 3).
  3. Scoring: candidates with count > 4 + size/4 get a best-partial-run
     log-odds score (Block::bestPartialLogScore); score >= 0 and width
     >= max(6, 0.3*size) is a hit.
  4. Chaining (FsHitCollection): hits link to the best predecessor hit
     of the neighboring block within 100 kb, minus 1e-5 per skipped base
     (monotone-deque DP); one best hit per chain is reported.

Host copy of `augustus_tpu/ppx/fastblock.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics
from .profile import AA_INDEX, MIN_BLOCKSIZE, NUM_AA, Profile

EXP_SEED_COUNT = 10000          # pp_fastBlockSearcher.cc:15
MAX_COVERAGE = 0.8              # pp_fastBlockSearcher.cc:16
MAX_INTRON_LEN = 100000         # pp_fastBlockSearcher.cc:12
INTRON_MALUS = 1e-5             # pp_fastBlockSearcher.cc:13


def _aa_index_of_codon(gcode: genetics.GeneticCode) -> np.ndarray:
    """(64,) codon id -> PP amino-acid index, -1 for stop/invalid."""
    out = np.full(64, -1, dtype=np.int64)
    for cid in range(64):
        out[cid] = AA_INDEX.get(str(gcode.aa_of_codon[cid]), -1)
    return out


class SeedCollection:
    """FsSeedCollection: aa-3-mer id -> [(block, offset), ...] (CSR)."""

    def __init__(self, prfl: Profile):
        seeds: Dict[int, List[Tuple[int, int]]] = {}
        self.size = 0
        for b, blk in enumerate(prfl.blocks):
            maxcount = EXP_SEED_COUNT // blk.size
            lq = blk.logQ
            vals = blk.values
            for i in range(blk.size - 2):
                q3 = (lq[i][:, None, None] + lq[i + 1][None, :, None]
                      + lq[i + 2][None, None, :]).ravel()
                p3 = (vals[i][:, None, None] * vals[i + 1][None, :, None]
                      * vals[i + 2][None, None, :]).ravel()
                tripids = np.arange(q3.shape[0])
                # multimap<double,int> iterated in reverse: descending q,
                # ties by descending triple id (reverse insertion order)
                order = np.lexsort((tripids, q3))[::-1]
                p = 0.0
                count = 0
                for t in order:
                    if count >= maxcount or p >= MAX_COVERAGE:
                        break
                    p += p3[t]
                    seeds.setdefault(int(t), []).append((b, i))
                    count += 1
                    self.size += 1
        # CSR over the 8000 possible 3-mer ids
        ptr = np.zeros(NUM_AA ** 3 + 1, dtype=np.int64)
        ent_b: List[int] = []
        ent_i: List[int] = []
        for val in range(NUM_AA ** 3):
            ptr[val + 1] = ptr[val]
            for (b, i) in seeds.get(val, ()):
                ent_b.append(b)
                ent_i.append(i)
                ptr[val + 1] += 1
        self.ptr = ptr
        self.ent_b = np.array(ent_b, dtype=np.int64)
        self.ent_i = np.array(ent_i, dtype=np.int64)


class Hit:
    __slots__ = ("pos", "blockNo", "reverse", "score", "blockfrom",
                 "blockto", "pathScore", "predecessor", "head")

    def __init__(self, pos: int, b: int, reverse: bool, score: float,
                 frm: int, to: int):
        self.pos = pos
        self.blockNo = b
        self.reverse = reverse
        self.score = score
        self.blockfrom = frm
        self.blockto = to
        self.pathScore = score
        self.predecessor: Optional["Hit"] = None
        self.head: "Hit" = self

    def start(self) -> int:
        return self.head.pos

    def link_to(self, queue: List["Hit"]) -> None:
        while queue and queue[0].pos < self.pos - MAX_INTRON_LEN:
            queue.pop(0)
        if queue:
            self.predecessor = queue[0]
            self.head = self.predecessor.head
            self.pathScore = self.predecessor.pathScore - \
                INTRON_MALUS * (self.pos - self.predecessor.pos) + self.score

    def push_on(self, queue: List["Hit"]) -> None:
        while queue:
            ht = queue[-1]
            if ht.pathScore < self.pathScore + \
                    INTRON_MALUS * (self.pos - ht.pos):
                queue.pop()
            else:
                break
        queue.append(self)


class HitCollection:
    """FsHitCollection: chain DP over block hits + best-per-chain list."""

    def __init__(self, nblocks: int):
        self.size = nblocks
        self.pending = [[[] for _ in range(nblocks)],
                        [[] for _ in range(nblocks)]]
        self.final: List[Hit] = []
        self.all_count = 0

    def new_hit(self, ht: Hit) -> None:
        self.all_count += 1
        queues = self.pending[1 if ht.reverse else 0]
        b = ht.blockNo + 1 if ht.reverse else ht.blockNo - 1
        if 0 <= b < self.size:
            ht.link_to(queues[b])
        if ht.reverse:
            for b in range(ht.blockNo, 0, -1):
                ht.push_on(queues[b])
        else:
            for b in range(ht.blockNo, self.size - 1):
                ht.push_on(queues[b])
        fr = self.final
        if not fr:
            fr.append(ht)
            return
        i = len(fr) - 1
        while i >= 0 and fr[i].start() > ht.start():
            i -= 1
        if i >= 0 and fr[i].head is ht.head:
            if fr[i].pathScore < ht.pathScore:
                fr[i] = ht
        elif i == len(fr) - 1:
            fr.append(ht)
        else:
            fr.insert(i + 1, ht)

    def best_results(self, threshold: float) -> List[Hit]:
        """storeBestResults with MINCOUNT=0: all chains above threshold,
        sorted ascending by pathScore (multimap order, stable)."""
        out = [ht for ht in self.final if ht.pathScore > threshold]
        out.sort(key=lambda h: h.pathScore)
        return out


def _triple_ids(aa: np.ndarray, n: int, reverse: bool) -> np.ndarray:
    """Valid aa-3-mer id per first-codon start p (length n-8), -1 invalid."""
    if n < 9:
        return np.empty(0, dtype=np.int64)
    a0, a1, a2 = aa[: n - 8], aa[3: n - 5], aa[6: n - 2]
    ok = (a0 >= 0) & (a1 >= 0) & (a2 >= 0)
    if reverse:
        # trip = 400*aa(p+6) + 20*aa(p+3) + aa(p)  (protein order on the
        # reverse strand runs right-to-left in DNA)
        trip = a2 * 400 + a1 * 20 + a0
    else:
        trip = a0 * 400 + a1 * 20 + a2
    return np.where(ok, trip, -1)


def search(seq: str, prfl: Profile, cutoff: float = 0.7,
           gcode: Optional[genetics.GeneticCode] = None,
           offset: int = 0) -> List[List[dict]]:
    """Run the fast block search on one sequence.

    Returns hit groups (above cutoff * total column count), each a list of
    per-block hit dicts in genomic order (the reference's printBestResults
    order), sorted by ascending chain score.
    """
    if gcode is None:
        gcode = genetics.GeneticCode(1)
    codes = genetics.encode(seq.lower())
    n = codes.shape[0]
    aa_tab = _aa_index_of_codon(gcode)
    cod = np.full(n, -1, dtype=np.int64)
    rc_ = np.full(n, -1, dtype=np.int64)
    if n >= 3:
        cod[: n - 2] = genetics.kmer_ids(codes, 3)
        rc_[: n - 2] = genetics.rc_kmer_ids(codes, 3)
    aaf = np.where(cod >= 0, aa_tab[np.clip(cod, 0, 63)], -2)
    aar = np.where(rc_ >= 0, aa_tab[np.clip(rc_, 0, 63)], -2)

    seedc = SeedCollection(prfl)
    coll = HitCollection(prfl.block_count())
    col_count = sum(b.size for b in prfl.blocks)

    # gather candidate hits for both strands, then emit them in the
    # reference's processing order: by pop time t = s + 3*size, forward
    # strand first, blocks in order
    pre_hits: List[Tuple[int, int, int, Hit]] = []
    for reverse in (False, True):
        aa = aar if reverse else aaf
        trips = _triple_ids(aa, n, reverse)
        valid = trips >= 0
        pv = np.flatnonzero(valid)
        if pv.size == 0:
            continue
        tv = trips[pv]
        cnt = seedc.ptr[tv + 1] - seedc.ptr[tv]
        tot = int(cnt.sum())
        if tot == 0:
            continue
        ev_p = np.repeat(pv, cnt)
        base = np.repeat(seedc.ptr[tv], cnt)
        within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ent = base + within
        ev_b = seedc.ent_b[ent]
        ev_i = seedc.ent_i[ent]
        sizes = np.array([prfl.block_size(int(b)) for b in
                          range(prfl.block_count())])
        if reverse:
            s = ev_p + 3 * ev_i + 9 - 3 * sizes[ev_b]
        else:
            s = ev_p - 3 * ev_i
        # accumulate min(|i - last_i|, 3) per (block, start) in event
        # order (= ascending p)
        order = np.lexsort((ev_p, s, ev_b))
        bo, so, io = ev_b[order], s[order], ev_i[order]
        first = np.ones(tot, dtype=bool)
        first[1:] = (bo[1:] != bo[:-1]) | (so[1:] != so[:-1])
        d = np.abs(np.diff(io, prepend=0))
        contrib = np.where(first, 3, np.minimum(d, 3))
        seg_idx = np.cumsum(first) - 1
        counts = np.bincount(seg_idx, weights=contrib)
        seg_b = bo[first]
        seg_s = so[first]
        thresholds = 4 + sizes // 4
        keep = (counts > thresholds[seg_b]) & (seg_s >= 0) & \
            (seg_s + 3 * sizes[seg_b] <= n - 1)
        for b_, s_ in zip(seg_b[keep], seg_s[keep]):
            b_, s_ = int(b_), int(s_)
            blk = prfl[b_]
            sz = blk.size
            if reverse:
                idx = s_ + 3 * (sz - 1 - np.arange(sz))
                aa_idx = aar[idx]
            else:
                aa_idx = aaf[s_ + 3 * np.arange(sz)]
            score, frm, to = blk.best_partial_log_score(reverse, aa_idx)
            width = to - frm
            if score >= 0 and width >= MIN_BLOCKSIZE and \
                    width >= 0.3 * sz:
                ht = Hit(s_, b_, reverse, score, frm, to)
                t_pop = s_ + 3 * sz
                pre_hits.append((t_pop, 1 if reverse else 0, b_, ht))

    pre_hits.sort(key=lambda x: (x[0], x[1], x[2]))
    for (_, _, _, ht) in pre_hits:
        coll.new_hit(ht)

    groups: List[List[dict]] = []
    for ht in coll.best_results(cutoff * col_count):
        chain: List[dict] = []
        cur: Optional[Hit] = ht
        while cur is not None:
            blk = prfl[cur.blockNo]
            sz = blk.size
            startpos = cur.pos + offset + 3 * (
                sz - cur.blockto if cur.reverse else cur.blockfrom)
            blseq = []
            for i in range(sz):
                if i < cur.blockfrom or i >= cur.blockto:
                    blseq.append(".")
                elif cur.reverse:
                    p = cur.pos + 3 * (sz - 1 - i)
                    a = aar[p] if p < n - 2 else -2
                    blseq.append("*" if rc_[p] >= 0 and
                                 gcode.aa_of_codon[rc_[p]] == "*"
                                 else ("X" if a < 0 else
                                       "GDERKNQSTAVLIFYWHMCP"[a]))
                else:
                    p = cur.pos + 3 * i
                    a = aaf[p] if p < n - 2 else -2
                    blseq.append("*" if cod[p] >= 0 and
                                 gcode.aa_of_codon[cod[p]] == "*"
                                 else ("X" if a < 0 else
                                       "GDERKNQSTAVLIFYWHMCP"[a]))
            chain.append({
                "startpos": startpos,
                "block_id": blk.id,
                "partial": (cur.blockfrom, cur.blockto)
                if (cur.blockfrom != 0 or cur.blockto != sz) else None,
                "strand": "-" if cur.reverse else "+",
                "mult": math.exp(cur.score / sz),
                "normed": blk.back_dist(0).normed(cur.score),
                "blseq": "".join(blseq),
                "path_score": cur.pathScore,
            })
            cur = cur.predecessor
        chain.reverse()            # genomic order (head first)
        groups.append({"score": ht.pathScore,
                       "mult": math.exp(ht.pathScore / col_count),
                       "hits": chain})
    return groups


def format_results(seqname: str, groups, out=None) -> str:
    """Reference fastBlockSearch stdout format (fastBlockSearch.cc:54)."""
    lines = [f"Hits found in {seqname}"]
    for g in groups:
        lines.append(f"Score:{g['score']:.6g}")
        lines.append(f"Mult. score:{g['mult']:.6g}")
        for h in g["hits"]:
            part = ""
            if h["partial"] is not None:
                part = f"[{h['partial'][0]},{h['partial'][1]}]"
            lines.append(
                f"{h['startpos']}\t{h['block_id']}{part}\t{h['strand']}\t"
                f"{h['mult']:.6g}\t{h['normed']:.6g}\t{h['blseq']}")
        lines.append("--")
    lines.append("")
    return "\n".join(lines) + "\n"
