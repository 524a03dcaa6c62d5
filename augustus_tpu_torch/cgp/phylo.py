"""Phylogenetic tree + continuous-time Markov chains for CGP.

Reference: src/phylotree.cc (Newick parsing via the generated
parser/scanner, Felsenstein pruning, MAP inference) and src/contTimeMC.cc
(Evo base class; ExonEvo 2-state exon gain/loss model with rates lambda/mu
and equilibrium pi; P(t) via eigendecomposition, contTimeMC.cc:116-140).

Transition matrices for all branches are precomputed as one (B, S, S)
array; Felsenstein pruning over all ortho exons runs as one vectorized
pass per tree node (the post-order traversal is data-independent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class TreeNode:
    name: str = ""
    length: float = 0.0          # branch length to parent
    children: List["TreeNode"] = field(default_factory=list)
    idx: int = -1                # post-order index


def parse_newick(text: str) -> TreeNode:
    """Minimal Newick parser (reference uses a bisonc++ grammar,
    src/parser/parse.cc; the accepted language here is the same
    name:length tree syntax used by --treefile)."""
    s = text.strip().rstrip(";").strip()
    pos = [0]

    def parse_node() -> TreeNode:
        node = TreeNode()
        if s[pos[0]] == "(":
            pos[0] += 1
            while True:
                node.children.append(parse_node())
                if s[pos[0]] == ",":
                    pos[0] += 1
                    continue
                if s[pos[0]] == ")":
                    pos[0] += 1
                    break
        # optional label
        start = pos[0]
        while pos[0] < len(s) and s[pos[0]] not in ",():;":
            pos[0] += 1
        node.name = s[start: pos[0]]
        if pos[0] < len(s) and s[pos[0]] == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(s) and s[pos[0]] not in ",();":
                pos[0] += 1
            node.length = float(s[start: pos[0]])
        return node

    return parse_node()


class PhyloTree:
    """Rooted tree with post-order node indexing for pruning.

    Reference: PhyloTree (include/phylotree.hh); species() returns leaf
    names in post-order, matching the leaf-state vectors handed to
    Felsenstein pruning.
    """

    def __init__(self, root: TreeNode):
        self.root = root
        self.nodes: List[TreeNode] = []
        self._post_order(root)
        self.leaves = [n for n in self.nodes if not n.children]
        self.leaf_names = [n.name for n in self.leaves]

    @classmethod
    def from_file(cls, path: str) -> "PhyloTree":
        with open(path) as fh:
            return cls(parse_newick(fh.read()))

    def _post_order(self, node: TreeNode) -> None:
        for ch in node.children:
            self._post_order(ch)
        node.idx = len(self.nodes)
        self.nodes.append(node)

    def branch_lengths(self) -> np.ndarray:
        return np.array([n.length for n in self.nodes])

    def drop_missing(self, present: List[str]) -> "PhyloTree":
        """Subtree induced by the present leaves (reference
        PhyloTree::prune for species absent from an alignment)."""
        keep = set(present)

        def rec(node: TreeNode) -> Optional[TreeNode]:
            if not node.children:
                return TreeNode(node.name, node.length) \
                    if node.name in keep else None
            kids = [rec(c) for c in node.children]
            kids = [k for k in kids if k is not None]
            if not kids:
                return None
            if len(kids) == 1:
                kids[0].length += node.length
                return kids[0]
            nn = TreeNode(node.name, node.length)
            nn.children = kids
            return nn

        r = rec(self.root)
        if r is None:
            r = TreeNode()
        return PhyloTree(r)


class ExonEvo:
    """Exon gain/loss continuous-time Markov chain (2 states: absent /
    present).  Reference: ExonEvo (include/contTimeMC.hh:130+,
    compgenepred.cc:165-187): rates lambda (gain) and mu (loss),
    equilibrium pi = (mu, lambda)/(lambda+mu), ali_error absorbed into
    the equilibrium.  P(t) = U exp(D t) U^-1 computed in closed form for
    the 2-state chain (the reference eigendecomposes with GSL)."""

    def __init__(self, lam: float = 0.0001, mu: float = 0.0001,
                 ali_error: float = 0.1):
        self.lam = lam
        self.mu = mu
        self.pi = np.array([mu, lam]) / (lam + mu)

    def P(self, t: np.ndarray) -> np.ndarray:
        """(B, 2, 2) transition matrices for branch lengths t."""
        t = np.asarray(t, dtype=np.float64)
        r = self.lam + self.mu
        e = np.exp(-r * t)
        p0, p1 = self.pi[0], self.pi[1]
        P = np.empty(t.shape + (2, 2))
        P[..., 0, 0] = p0 + p1 * e
        P[..., 0, 1] = p1 * (1 - e)
        P[..., 1, 0] = p0 * (1 - e)
        P[..., 1, 1] = p1 + p0 * e
        return P


def felsenstein_batch(tree: PhyloTree, evo: ExonEvo,
                      leaf_states: np.ndarray) -> np.ndarray:
    """log P(leaf pattern) for a batch of ortho exons under the exon
    gain/loss model.

    leaf_states: (N, L) int8, entry -1 = species absent from the
    alignment (marginalized), 0 = exon absent, 1 = exon present;
    column order = tree.leaf_names.
    Returns (N,) log-likelihoods.

    Reference: PhyloTree::pruningAlgorithm (phylotree.cc); the reference
    iterates HECTs one at a time — here the recursion is one vectorized
    pass per tree node over the whole batch (numpy: trees are tiny and N
    is modest).
    """
    N = leaf_states.shape[0]
    P = evo.P(tree.branch_lengths())          # (B, 2, 2)
    like: Dict[int, np.ndarray] = {}
    leaf_col = {n.idx: i for i, n in enumerate(tree.leaves)}
    for node in tree.nodes:
        if not node.children:
            col = leaf_states[:, leaf_col[node.idx]]
            L = np.zeros((N, 2))
            L[col == -1] = 1.0
            L[col == 0, 0] = 1.0
            L[col == 1, 1] = 1.0
        else:
            L = np.ones((N, 2))
            for ch in tree.nodes[0:0] + node.children:
                # P[ch] @ like[ch]: (2,2) x (N,2) -> (N,2)
                L = L * (like[ch.idx] @ P[ch.idx].T)
        like[node.idx] = L
    root = like[tree.root.idx]
    with np.errstate(divide="ignore"):
        return np.log(np.maximum(root @ evo.pi, 1e-300))
