"""Cross-species objective: dual decomposition over species graphs.

Reference: src/orthograph.cc — OrthoGraph::dualdecomp (:329) alternates
per-species longest path (globalPathSearch :317) with MAP inference on
each ortho exon's phylogenetic tree (treeMAPInf :500), coupling the two
through Lagrange multipliers updated by a subgradient rule
(square-root-of-iteration step, compgenepred.cc:260-272).

The tree MAP step enumerates leaf labelings exactly (vectorized
Felsenstein over all 2^L patterns x all HECTs at once — L is the species
count, so the full table is tiny) instead of the reference's per-HECT
message passing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .orthoexon import OrthoExon
from .phylo import ExonEvo, PhyloTree, felsenstein_batch
from .speciesgraph import PathNode, longest_paths


def dual_decomp(tree: PhyloTree, evo: ExonEvo,
                species_nodes: Dict[str, List[PathNode]],
                hects: List[OrthoExon],
                seq_lens: Dict[str, int],
                rounds: int = 3, iterations: int = 20,
                phylo_weight: float = 8.0):
    """Run dual decomposition; returns (paths per species, support per
    HECT).  Node.bonus fields are mutated in place across iterations.

    reference defaults: <=500 iterations x 5 rounds (compgenepred.cc:
    240-255); graphs here are small enough that far fewer suffice.
    """
    specs = tree.leaf_names
    sidx = {s: i for i, s in enumerate(specs)}
    L = len(specs)

    # hect membership: node -> list of (hect index, species)
    node_of: Dict[Tuple[str, tuple], PathNode] = {}
    for s, nodes in species_nodes.items():
        for nd in nodes:
            node_of[(s, nd.ec.key())] = nd
    members: List[List[Tuple[str, PathNode]]] = []
    for hi, oe in enumerate(hects):
        mem = []
        for s, ec in oe.members.items():
            nd = node_of.get((s, ec.key()))
            if nd is not None:
                mem.append((s, nd))
                nd.hects.append(hi)
        members.append(mem)

    # all-labelings Felsenstein table: (2^L, ) log-lik per pattern for a
    # generic HECT, adjusted per HECT by masking absent species
    patterns = np.array([[int(b) for b in np.binary_repr(p, L)]
                         for p in range(1 << L)], dtype=np.int8)
    loglik_all = felsenstein_batch(tree, evo, patterns)       # (2^L,)

    mu: Dict[Tuple[int, str], float] = {}
    for hi, mem in enumerate(members):
        for s, _ in mem:
            mu[(hi, s)] = 0.0

    paths: Dict[str, List[List[PathNode]]] = {}
    best_err = None
    for r in range(rounds):
        for it in range(iterations):
            step = phylo_weight / np.sqrt(it + 1.0)
            # --- per-species longest paths with current multipliers -----
            x: Dict[Tuple[int, str], int] = {}
            for s, nodes in species_nodes.items():
                for nd in nodes:
                    nd.bonus = sum(-mu.get((hi, s), 0.0)
                                   for hi in nd.hects)
                paths[s] = longest_paths(nodes, seq_lens[s])
                in_path = {id(nd) for chain in paths[s] for nd in chain}
                for hi, mem in enumerate(members):
                    for ms, nd in mem:
                        if ms == s:
                            x[(hi, s)] = 1 if id(nd) in in_path else 0
            # --- per-HECT tree MAP with multipliers ---------------------
            y: Dict[Tuple[int, str], int] = {}
            disagree = 0
            for hi, (oe, mem) in enumerate(zip(hects, members)):
                if not mem:
                    continue
                mem_idx = [sidx[s] for s, _ in mem]
                free = [i for i in range(L) if i not in mem_idx]
                # score every labeling of member species (absent species
                # marginalized = choose best label; graphs can't see them)
                best, best_p = -np.inf, 0
                for p in range(1 << len(mem_idx)):
                    lab = {mem_idx[k]: (p >> k) & 1
                           for k in range(len(mem_idx))}
                    # full patterns consistent with lab: max over free
                    sel = np.ones(1 << L, dtype=bool)
                    for i, v in lab.items():
                        bit = (np.arange(1 << L) >> (L - 1 - i)) & 1
                        sel &= bit == v
                    ll = float(loglik_all[sel].max())
                    val = phylo_weight * ll + sum(
                        mu[(hi, s)] * lab[sidx[s]] for s, _ in mem)
                    if val > best:
                        best, best_p = val, p
                for k, (s, _) in enumerate(mem):
                    y[(hi, s)] = (best_p >> k) & 1
                # posterior-ish support for the score column: logistic of
                # present-vs-absent log-odds at the observed pattern
                pres = [1 if x.get((hi, s), 0) else 0 for s, _ in mem]
                lab_on = {sidx[s]: 1 for s, _ in mem}
                lab_off = {sidx[s]: 0 for s, _ in mem}

                def _ll(lab):
                    sel = np.ones(1 << L, dtype=bool)
                    for i, v in lab.items():
                        bit = (np.arange(1 << L) >> (L - 1 - i)) & 1
                        sel &= bit == v
                    return float(loglik_all[sel].max())

                lo = _ll(lab_on) - _ll(lab_off)
                support = 1.0 / (1.0 + np.exp(-lo - 0.5 * (len(mem) - 1)))
                oe.phylo_score = lo
                for s, nd in mem:
                    nd.support = max(nd.support, support)
            # --- subgradient update ------------------------------------
            for key in mu:
                gx = x.get(key, 0)
                gy = y.get(key, 0)
                disagree += int(gx != gy)
                mu[key] += step * (gx - gy)
            if best_err is None or disagree < best_err:
                best_err = disagree
            if disagree == 0:
                return paths, hects
    return paths, hects
