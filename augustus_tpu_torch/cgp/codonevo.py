"""Codon substitution model with omega (dN/dS) grid — CGP's scoring brain.

Mirrors reference src/codonevo.cc + src/contTimeMC.cc:
  * getCodonRateMatrix (codonevo.cc:330): 64x64 reversible rate matrix from
    codon usage pi, kappa (transition/transversion) and omega
    (nonsynonymous factor), normalized to one expected mutation per time
    unit;
  * the omega grid around 1 (CodonEvo::setOmegas, codonevo.cc:34) with a
    normal(1, sigma) prior (setPrior, codonevo.cc:63);
  * spectral decomposition via the pi-symmetrization
    B = diag(pi^1/2) Q diag(pi^-1/2) (contTimeMC.cc:116) — here one
    batched numpy `eigh` over all omegas at once instead of per-matrix
    GSL calls;
  * P(t) = U exp(lambda t) U^-1 on a discretized branch-length grid
    (Evo::setBranchLengths, contTimeMC.cc:48);
  * Felsenstein pruning over codon tuples (PhyloTree::pruningAlgor,
    phylotree.cc:241) — vectorized over alignment columns AND the omega
    grid (the reference loops both);
  * estOmegaOnSeqTuple (codonevo.cc:510): ML omega over the grid plus a
    Fitch-parsimony substitution count.

Divergence from the reference: codon usage pi is estimated by counting
codons in the gene range's candidate exons (deterministic) instead of
sampling 20000 codons from the emission Markov chain with glibc rand()
(ExonModel::getCodonUsage, exonmodel.cc:802) — the reference's pi is
itself a stochastic approximation of the same distribution.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics

PURINE = np.array([True, False, True, False])        # a, c, g, t


def codon_rate_matrix(pi: np.ndarray, omega: float, kappa: float
                      ) -> np.ndarray:
    """64x64 rate matrix Q (reference getCodonRateMatrix)."""
    gcode = genetics.GeneticCode(1)
    aa = gcode.aa_of_codon
    Q = np.zeros((64, 64))
    for i in range(64):
        if pi[i] <= 0.0:
            continue
        ci = [(i >> 4) & 3, (i >> 2) & 3, i & 3]
        for f in range(3):
            for d in range(4):
                if d == ci[f]:
                    continue
                cj = list(ci)
                cj[f] = d
                j = 16 * cj[0] + 4 * cj[1] + cj[2]
                qij = pi[j]
                if PURINE[d] == PURINE[ci[f]]:
                    qij *= kappa
                if aa[i] != aa[j]:
                    qij *= omega
                Q[i, j] = qij
    rowsum = Q.sum(axis=1)
    Q[np.arange(64), np.arange(64)] = -rowsum
    scale = float((rowsum * pi).sum())
    scale = 1.0 / scale if scale != 0.0 else 1.0
    return Q * scale


def omega_grid(k: int) -> np.ndarray:
    """CodonEvo::setOmegas: k omegas around 1 (codonevo.cc:34)."""
    c = 2
    r = int(0.5 + (k - 1) / 2.0)
    rr = k - 1 - r
    out = []
    for i in range(r, 0, -1):
        out.append(1 - i / (c + r))
    out.append(1.0)
    for i in range(1, rr + 1):
        out.append(1.0 / (1 - i / (c + r)))
    return np.array(out)


def omega_prior(omegas: np.ndarray, sigma: float = 0.5) -> np.ndarray:
    """CodonEvo::setPrior: normal(1, sigma), folded for omega > 1."""
    w = omegas.copy()
    big = w > 1.0
    w[big] = np.sqrt(-2 * np.log(1.0 / w[big]) * sigma ** 2
                     + (1.0 / w[big] - 1.0) ** 2) + 1
    t = (w - 1.0) / sigma
    p = np.exp(-t * t / 2)
    return p / p.sum()


class CodonEvo:
    """Omega-grid codon model with precomputed P(t) tensors.

    P matrices are computed for all (omega, time) pairs in one batched
    einsum in place of the reference's double loop of GSL expQt calls
    (codonevo.cc:217)."""

    def __init__(self, pi: np.ndarray, branch_lengths: List[float],
                 k: int = 20, kappa: float = 4.0, sigma: float = 0.5,
                 m: int = 25):
        self.pi = np.asarray(pi, dtype=np.float64)
        self.omegas = omega_grid(k)
        self.prior = omega_prior(self.omegas, sigma)
        self.kappa = kappa
        # time grid (Evo::setBranchLengths)
        times = sorted(set(branch_lengths))
        if 0 < m < len(times):
            lo, hi = times[0], times[-1]
            step = (hi - lo) / (m - 1)
            times = [lo + i * step for i in range(m)]
        elif m == 1 and branch_lengths:
            times = [sum(branch_lengths) / len(branch_lengths)]
        self.times = np.array(times if times else [1.0])

        # batched spectral decomposition over omegas
        K = self.omegas.shape[0]
        Qs = np.stack([codon_rate_matrix(self.pi, float(w), kappa)
                       for w in self.omegas])
        pos = self.pi > 0
        sq = np.where(pos, np.sqrt(np.where(pos, self.pi, 1.0)), 1.0)
        B = Qs * (sq[None, :, None] / sq[None, None, :])
        B = np.where(pos[None, :, None] & pos[None, None, :], B, 0.0)
        lam, V = np.linalg.eigh(B)                       # (K,64),(K,64,64)
        U = V / sq[None, :, None]
        Uinv = np.swapaxes(V, 1, 2) * sq[None, None, :]
        # P[u, v] = U exp(lam * t_v) Uinv  for all omegas/times at once
        E = np.exp(lam[:, None, :] * self.times[None, :, None])
        self.P = np.einsum("kij,kvj,kjl->kvil", U, E, Uinv)
        np.maximum(self.P, 0.0, out=self.P)
        with np.errstate(divide="ignore"):
            self.logP = np.log(self.P)

    def time_index(self, t: float) -> int:
        return int(np.argmin(np.abs(self.times - t)))

    # ---- pruning over codon tuples -------------------------------------
    def loglik_columns(self, tree, tuples: np.ndarray) -> np.ndarray:
        """Felsenstein pruning, batched over columns and omegas.

        tree: cgp.phylo.PhyloTree (post-order nodes); tuples: (ncol,
        nspecies) int codon ids, 64 = missing.  Returns (K, ncol) log
        likelihoods (reference pruningAlgor per column per omega)."""
        K = self.omegas.shape[0]
        ncol = tuples.shape[0]
        eye = np.vstack([np.eye(64), np.ones(64)])       # 64 = missing
        tables: Dict[int, np.ndarray] = {}
        for node in tree.nodes:
            if not node.children:
                L = eye[tuples[:, tree.leaf_names.index(node.name)]]
                tables[id(node)] = np.broadcast_to(L, (K, ncol, 64))
            else:
                score = np.ones((K, ncol, 64))
                for ch in node.children:
                    Pt = self.P[:, self.time_index(ch.length)]  # (K,64,64)
                    s = np.einsum("kij,kcj->kci", Pt, tables[id(ch)])
                    score = score * s
                tables[id(node)] = score
        root = tables[id(tree.nodes[-1])]
        with np.errstate(divide="ignore"):
            return np.log(np.einsum("kci,i->kc", root, self.pi))

    def est_omega(self, tree, tuples: np.ndarray) -> Tuple[float, int, float]:
        """(ML omega, substitution count, posterior mean omega) for one
        codon-tuple alignment (reference estOmegaOnSeqTuple,
        codonevo.cc:510; the posterior uses the normal prior)."""
        use = (tuples < 64).sum(axis=1) >= 2
        if not use.any():
            return 1.0, 0, 1.0
        ll = self.loglik_columns(tree, tuples[use]).sum(axis=1)  # (K,)
        u = int(np.argmax(ll))
        # posterior mean over the grid
        w = ll + np.log(self.prior)
        w -= w.max()
        p = np.exp(w)
        p /= p.sum()
        post_mean = float((p * self.omegas).sum())
        subst = fitch_substitutions(tree, tuples[use])
        return float(self.omegas[u]), subst, post_mean


def fitch_substitutions(tree, tuples: np.ndarray) -> int:
    """Fitch parsimony count of codon substitutions, batched over columns
    (reference reduces MAP to Fitch, codonevo.cc:553-572)."""
    ncol = tuples.shape[0]
    total = np.zeros(ncol, dtype=np.int64)
    sets: Dict[int, np.ndarray] = {}
    for node in tree.nodes:
        if not node.children:
            c = tuples[:, tree.leaf_names.index(node.name)]
            s = np.zeros((ncol, 64), dtype=bool)
            known = c < 64
            s[known, c[known]] = True
            s[~known, :] = True               # missing: any codon
            sets[id(node)] = s
        else:
            acc = None
            for ch in node.children:
                s = sets[id(ch)]
                if acc is None:
                    acc = s
                else:
                    inter = acc & s
                    empty = ~inter.any(axis=1)
                    total += empty
                    acc = np.where(empty[:, None], acc | s, inter)
            sets[id(node)] = acc
    return int(total.sum())


def estimate_pi(seqs: List[str]) -> np.ndarray:
    """Codon usage from candidate exon sequences, stop codons zeroed
    (deterministic substitute for ExonModel::getCodonUsage sampling)."""
    counts = np.ones(64)
    for s in seqs:
        codes = genetics.encode(s.lower())
        ncod = codes.shape[0] // 3
        if ncod == 0:
            continue
        cods = codes[: ncod * 3].reshape(ncod, 3).astype(np.int64)
        ok = (cods < 4).all(axis=1)
        idx = cods[ok, 0] * 16 + cods[ok, 1] * 4 + cods[ok, 2]
        counts += np.bincount(idx, minlength=64)
    gcode = genetics.GeneticCode(1)
    counts[gcode.is_stop] = 0.0
    return counts / counts.sum()
