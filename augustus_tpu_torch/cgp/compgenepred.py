"""Comparative gene prediction driver.

Reference: src/compgenepred.cc — CompGenePred::start (:131): read tree +
genomes, read the MAF, chain alignments into gene ranges, then per range:
fetch per-species sequences, sample/decode transcripts with NAMGene,
build exon candidates, project them across the alignment into ortho
exons, score them phylogenetically, couple the per-species graphs with
dual decomposition, and write one .cgp GFF per species.

This driver keeps that exact pipeline shape; the per-species decode runs
on the single-genome path of the port (`predict._find_genes` on the
device that `start` resolves: the device route with csrc/prefix.cu, K1
and the event walk K4 on the card), the Felsenstein scoring is a batched
vectorized pass (cgp/phylo.py), and the dual decomposition follows
orthograph.cc's subgradient scheme (cgp/orthograph.py).

One difference from augustus_tpu/cgp/compgenepred.py: a decode that
raises is not caught (augustus_tpu goes on with the exon candidates
alone), so a kernel that fails to build or launch stops the run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import genetics
from ..engine.gold import GoldEngine
from ..model.state_config import ST
from ..output import genes as og
from .alignment import GeneRange, find_gene_ranges, read_maf
from .exoncand import (ExonCandidate, INITIAL, INTERNAL, SINGLE, TERMINAL,
                       dedupe, generate_exon_candidates)
from .orthoexon import create_ortho_exons, species_aligned
from .orthograph import dual_decomp
from .phylo import ExonEvo, PhyloTree
from .seq_access import MemSeqAccess
from .speciesgraph import PathNode, longest_paths, score_candidates

# Viterbi decode exons carry the full GHMM signal (the reference gets the
# analogous evidence from sampled-path posteriors); ortho exons add a
# codon-evolution bonus from the omega (dN/dS) posterior — purifying
# selection (omega < 1) is evidence for real coding exons (reference
# scores this via CodonEvo omegas + logistic-regression features,
# src/codonevo.cc:510, src/compgenepred.cc:489-517).
VITERBI_PRIOR = 15.0
OMEGA_BONUS = 20.0


class CompGenePred:
    def __init__(self, model, tree_file: str, aln_file: str,
                 species_files: str, outdir: str = ".",
                 dbaccess: str = None):
        self.model = model
        self.tree = PhyloTree.from_file(tree_file)
        # reference compgenepred.cc:94-127: --dbaccess=<file>.db selects
        # the SQLite store, a "dbname,host,user,passwd[,port]" spec the
        # MySQL store, otherwise genomes load into memory
        if dbaccess:
            from .mysql_db import is_mysql_dbaccess
            if is_mysql_dbaccess(dbaccess):
                from .mysql_db import MysqlAccess
                self.rsa = MysqlAccess(dbaccess, species_files)
            else:
                from .sqlite_db import SQLiteAccess
                self.rsa = SQLiteAccess(dbaccess, species_files)
        else:
            self.rsa = MemSeqAccess(species_files)
        self.aln_file = aln_file
        self.outdir = outdir
        self.evo = ExonEvo(
            lam=model.props.get_float("/CompPred/exon_gain", 0.0001),
            mu=model.props.get_float("/CompPred/exon_loss", 0.0001))

    # ------------------------------------------------------------------
    def start(self, device=None) -> Dict[str, str]:
        """Run CGP; writes <species>.cgp.gff into outdir and returns
        {species: gff text} (reference writes per-species streams,
        compgenepred.cc:566+).  Each species' range decodes on `device`
        (predict.resolve_device: cuda unless the caller asks for the CPU;
        it raises without a card before any output file is written)."""
        from ..predict import resolve_device
        device = resolve_device(device)
        species = self.rsa.species()
        alis = read_maf(self.aln_file, species=species)
        ref_spec = species[0]
        ranges = find_gene_ranges(alis, ref_spec)
        texts = {s: [] for s in species}
        gid = {s: 1 for s in species}
        for gr in ranges:
            self._predict_range(gr, texts, gid, device)
        out = {}
        os.makedirs(self.outdir, exist_ok=True)
        for s in species:
            hdr = []
            body = "".join(texts[s])
            out[s] = body
            with open(os.path.join(self.outdir, f"{s}.cgp.gff"), "w") as fh:
                fh.write(body)
        # ortho-exon tracks with omega attributes (reference writes
        # orthoExons.<species>.gff3, geneMSA.cc:516-529)
        for s, lines in getattr(self, "_oe_lines", {}).items():
            with open(os.path.join(self.outdir,
                                   f"orthoExons.{s}.gff3"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
        return out

    # ------------------------------------------------------------------
    def _decode_exons(self, codes, softmask, device) -> List[ExonCandidate]:
        """Viterbi transcripts of the single-genome model, as candidates
        (reference samples transcripts via NAMGene, compgenepred.cc:706).
        An error of the decode rises to the caller."""
        from ..predict import _find_genes
        agl, _ = _find_genes(self.model, codes, softmask, None, device)
        out: List[ExonCandidate] = []
        for ag in agl:
            for tx in ag.transcripts:
                exs = tx.exons
                plus = tx.strand == "+"
                phase = 0
                items = exs if plus else list(reversed(exs))
                for i, st in enumerate(items):
                    if len(items) == 1:
                        et = SINGLE
                    elif i == 0:
                        et = INITIAL
                    elif i == len(items) - 1:
                        et = TERMINAL
                    else:
                        et = INTERNAL
                    b, e = st.begin, st.end
                    ln = e - b + 1
                    fr = phase if plus else (3 - (phase + ln) % 3) % 3
                    # frame convention: phase of the forward-coordinate
                    # begin base within the codon chain of the transcript
                    out.append(ExonCandidate(b, e, et, tx.strand,
                                             phase % 3))
                    phase = (phase + ln) % 3
        return out

    # ------------------------------------------------------------------
    def _predict_range(self, gr: GeneRange, texts, gid, device) -> None:
        cn = self.model.cn
        species_nodes: Dict[str, List[PathNode]] = {}
        cands: Dict[str, List[ExonCandidate]] = {}
        seq_lens: Dict[str, int] = {}
        seqs: Dict[str, str] = {}
        for spec, (seqid, lo, hi, strand) in gr.intervals.items():
            if strand != "+":
                continue      # the example MAFs are all forward
            hi = min(hi, self.rsa.seq_len(spec, seqid) - 1)
            seq = self.rsa.get_seq(spec, seqid, lo, hi)
            seqs[spec] = seq
            n = len(seq)
            seq_lens[spec] = n
            codes = genetics.encode(seq.lower())
            softmask = genetics.softmask_runs(seq) if cn.softmasking \
                else None
            eng = GoldEngine(self.model.sg, cn, self.model.igp,
                             self.model.exp, self.model.inp,
                             self.model.decomp, self.model.gcode,
                             utr=self.model.utr,
                             utr_cfg=self.model.utr_cfg,
                             ext_cfg=self.model.ext_cfg)
            eng.prepare(codes, softmask=softmask)
            vit = self._decode_exons(codes, softmask, device)
            ecs = generate_exon_candidates(seq)
            all_c = dedupe(vit + ecs)
            nodes = score_candidates(eng, all_c)
            vit_keys = {ec.key() for ec in vit}
            for nd in nodes:
                if nd.ec.key() in vit_keys:
                    nd.base += VITERBI_PRIOR
            # cap the graph: all decode exons + the best candidates
            # (reference prunes via sampling posteriors + EC thresholds)
            keep = [nd for nd in nodes if nd.ec.key() in vit_keys]
            rest = sorted((nd for nd in nodes
                           if nd.ec.key() not in vit_keys),
                          key=lambda nd: -nd.base)[:1500]
            nodes = keep + rest
            species_nodes[spec] = nodes
            cands[spec] = [nd.ec for nd in nodes]

        if not species_nodes:
            return
        hects = create_ortho_exons(gr, cands)
        hects.sort(key=lambda oe: -len(oe.members))
        hects = hects[:500]
        tree = self.tree.drop_missing(list(species_nodes))
        self._score_omegas(tree, hects, seqs, species_nodes, gr)
        paths, hects = dual_decomp(tree, self.evo, species_nodes, hects,
                                   seq_lens)

        for spec, chains in paths.items():
            seqid, lo, hi, _ = gr.intervals[spec]
            n = seq_lens[spec]
            codes = genetics.encode(seqs[spec].lower())
            header = (f"#----- prediction on sequence range {seqid}:"
                      f"{lo + 1}-{min(hi + 1, lo + n)} ({n}bp) -----\n#\n")
            genes = [self._chain_to_gene(ch, spec, seqid, gid)
                     for ch in chains]
            genes = [g for g in genes if g is not None]
            genes.sort(key=lambda g: g.gene_begin())
            body = []
            o = og.OutputOptions.from_properties(self.model.props)
            for g in genes:
                g.seqname = seqid
                g.id = "t1"
                g.geneid = f"g{gid[spec]}"
                gid[spec] += 1
                for st in g.exons + g.introns:
                    st.begin += lo
                    st.end += lo
                for attr in ("codingstart", "codingend"):
                    v = getattr(g, attr)
                    if v >= 0:
                        setattr(g, attr, v + lo)
                body.append(f"# start gene {g.geneid}\n")
                lines: List[str] = []
                og.print_gene_gff(g, o, lines)
                body.append("\n".join(lines) + "\n")
                body.append(f"# end gene {g.geneid}\n###\n")
            texts[spec].append(header + "".join(body))

    # ------------------------------------------------------------------
    def _score_omegas(self, tree, hects, seqs, species_nodes, gr) -> None:
        """Per-HECT omega (dN/dS) estimation on codon alignments and the
        derived exon-candidate bonus (replaces the former flat bonus).

        Reference: CompGenePred computes omegas on ortho-exon codon
        alignments (computeOmegasEff, compgenepred.cc:837 ->
        codonevo.cc:510) and feeds them into the exon scoring.  Codon
        tuples here are built by trimming member exon sequences to the
        common codon count (adequate for colinear alignments; gap-aware
        tuple extraction via the MAF rows is a TODO noted in
        cgp/alignment.py)."""
        from .codonevo import CodonEvo, estimate_pi
        if not hects:
            self._oe_lines = getattr(self, "_oe_lines", {})
            return
        exon_seqs = []
        for oe in hects:
            for spec, ec in oe.members.items():
                if spec in seqs:
                    exon_seqs.append(seqs[spec][ec.begin: ec.end + 1])
        pi = estimate_pi(exon_seqs)
        k = self.model.props.get_int("/CompPred/num_omega", 20)
        bl = [n.length for n in tree.nodes if n is not tree.root]
        evo = CodonEvo(pi, bl if bl else [0.1], k=k)
        node_by_key = {
            spec: {nd.ec.key(): nd for nd in nodes}
            for spec, nodes in species_nodes.items()}
        self._oe_lines = getattr(self, "_oe_lines", {})
        self._oe_id = getattr(self, "_oe_id", 0)
        leaf_order = tree.leaf_names
        for oe in hects:
            membs = [(s, ec) for s, ec in oe.members.items() if s in seqs]
            if len(membs) < 2:
                continue
            ncod = min((ec.end - ec.begin + 1 - ec.frame) // 3
                       for _, ec in membs)
            if ncod < 2:
                continue
            tuples = np.full((ncod, len(leaf_order)), 64, dtype=np.int64)
            for s, ec in membs:
                if s not in leaf_order:
                    continue
                col = leaf_order.index(s)
                sub = seqs[s][ec.begin + ec.frame:
                              ec.begin + ec.frame + 3 * ncod]
                codes = genetics.encode(sub.lower())
                cods = codes.reshape(ncod, 3).astype(np.int64)
                ok = (cods < 4).all(axis=1)
                ids = cods[:, 0] * 16 + cods[:, 1] * 4 + cods[:, 2]
                tuples[ok, col] = ids[ok]
            omega, subst, post = evo.est_omega(tree, tuples)
            oe.omega = omega
            oe.subst = subst
            oe.post_omega = post
            self._oe_id += 1
            oe.ID = self._oe_id
            # conserved coding evidence: omega posterior below 1
            bonus = OMEGA_BONUS * max(0.0, 1.0 - post) * \
                min(ncod, 20) / 20.0
            for s, ec in membs:
                nd = node_by_key.get(s, {}).get(ec.key())
                if nd is not None:
                    nd.base += bonus
            # orthoExons.<species>.gff3 lines (reference
            # GeneMSA::printSingleOrthoExon, geneMSA.cc:529)
            tname = {SINGLE: "single", INITIAL: "initial",
                     INTERNAL: "internal", TERMINAL: "terminal"}
            for s, ec in membs:
                seqid, lo, hi, _ = gr.intervals[s]
                line = (f"{seqid}\tOE1\texon\t{ec.begin + lo + 1}\t"
                        f"{ec.end + lo + 1}\t{ec.score:.3g}\t{ec.strand}\t"
                        f"{(3 - ec.frame) % 3}\t"
                        f"ID={oe.ID};Name={oe.ID};"
                        f"Note={tname.get(ec.etype, 'exon')};"
                        f"n={len(oe.members)};MLomega={omega:g};"
                        f"Eomega={post:g};subst={subst}")
                self._oe_lines.setdefault(s, []).append(line)

    # ------------------------------------------------------------------
    def _chain_to_gene(self, chain: List[PathNode], spec: str, seqid: str,
                       gid) -> Optional[og.Gene]:
        if not chain:
            return None
        g = og.Gene()
        g.seqname = seqid
        g.strand = chain[0].ec.strand
        plus = g.strand == "+"
        clength = 0
        nex = len(chain)
        from ..model.state_config import (initial_exon_type,
                                          internal_exon_type,
                                          r_internal_exon_type,
                                          r_terminal_exon_type)
        items = chain
        for i, nd in enumerate(items):
            b, e = nd.ec.begin, nd.ec.end
            clength += e - b + 1
            if nex == 1:
                t = ST.singleG if plus else ST.rsingleG
            elif (i == 0 and plus) or (i == nex - 1 and not plus):
                t = initial_exon_type(clength) if plus else ST.rinitial
            elif (i == nex - 1 and plus) or (i == 0 and not plus):
                t = ST.terminal if plus else \
                    r_terminal_exon_type(2 - clength)
            else:
                t = (internal_exon_type(clength) if plus
                     else r_internal_exon_type(2 - clength))
            ps = og.PathState(b, e, t)
            ps.has_score = True
            ps.apostprob = round(nd.support, 2)
            g.exons.append(ps)
            if i + 1 < nex:
                nb = items[i + 1].ec.begin
                g.introns.append(og.PathState(e + 1, nb - 1,
                                              ST.intron_type))
        g.codingstart = chain[0].ec.begin
        g.codingend = chain[-1].ec.end
        g.transstart = -1
        g.transend = -1
        g.complete5utr = True
        g.complete3utr = True
        return g
