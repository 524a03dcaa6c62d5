"""Alternatives from evidence: prediction schemes over hint groups.

Port of `augustus_tpu/hints/alternatives.py`.  As there, no prediction
calls it: --alternatives-from-evidence is accepted and changes nothing.

Reference: PredictionRun / PredictionScheme (include/extrinsicinfo.hh:
37-71), SequenceFeatureCollection::determineInterGroupRelations
(extrinsicinfo.cc:1073), createPredictionScheme (:1378) and the
transcript filter of joinGenesFromPredRuns (:1501): with
--alternatives-from-evidence=true, every hint group that could cause an
alternative splice form and is neither overruled by a higher-priority
incompatible group nor weaker than a stronger group gets one extra
prediction run with its incompatible groups deactivated; transcripts
from a run survive only if their best supporting group is one of the
run's causing groups (supportingFraction >= 0.8 or >= the best outside
support).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .features import HintGroup
from .system import SeqHints, _compatible, _weaker_than

CAN_CAUSE_ALT_SPLICE = {"intron", "exon", "tss", "tts", "start", "stop",
                        "ass", "dss", "ip", "CDS", "CDSpart", "UTR",
                        "UTRpart"}


@dataclass
class PredictionRun:
    begin: int
    end: int
    omitted: Optional[List[HintGroup]]
    all_hints: bool = False


def group_compatible(g1: HintGroup, g2: HintGroup) -> Tuple[bool, bool]:
    """(compatible, weakerThan) for two groups (reference
    HintGroup::compatibleWith, hints.cc)."""
    if g1.begin > g2.end or g1.end < g2.begin:
        return True, False
    compatible = True
    weaker = True
    strictly = False
    for f1 in g1.hints:
        fw = False
        for f2 in g2.hints:
            if not _compatible(f1, f2):
                compatible = False
                return False, False
            wt, sly = _weaker_than(f1, f2)
            fw = fw or wt
            if wt:
                strictly = strictly or sly
        weaker = weaker and fw
    if weaker and not strictly:
        for f2 in g2.hints:
            if f2.end < g1.begin or f2.start > g1.end:
                strictly = True
    return True, weaker and strictly


def can_cause_alt_splice(g: HintGroup) -> bool:
    return any(h.type in CAN_CAUSE_ALT_SPLICE for h in g.hints)


def inter_group_relations(groups: List[HintGroup]):
    """incomp / stronger lists per group (determineInterGroupRelations)."""
    incomp: Dict[int, List[HintGroup]] = {id(g): [] for g in groups}
    stronger: Dict[int, List[HintGroup]] = {id(g): [] for g in groups}
    for i, g1 in enumerate(groups):
        for g2 in groups[i + 1:]:
            if g2.begin > g1.end:
                break
            comp12, weak12 = group_compatible(g1, g2)
            comp21, weak21 = group_compatible(g2, g1)
            if not (comp12 and comp21):
                incomp[id(g1)].append(g2)
                incomp[id(g2)].append(g1)
            else:
                if weak12:
                    stronger[id(g1)].append(g2)
                if weak21:
                    stronger[id(g2)].append(g1)
    return incomp, stronger


def create_prediction_scheme(sh: SeqHints, genes, seqlen: int
                             ) -> List[PredictionRun]:
    """reference createPredictionScheme (extrinsicinfo.cc:1378)."""
    groups = sh.groups
    if not groups:
        return []
    incomp, stronger = inter_group_relations(groups)
    runs: List[PredictionRun] = []
    for g in groups:
        overruled = any(o.priority >= 0 and g.priority >= 0 and
                        o.priority > g.priority for o in incomp[id(g)])
        weaker = any(g.priority >= 0 and o.priority >= g.priority
                     for o in stronger[id(g)])
        if can_cause_alt_splice(g) and not overruled and not weaker:
            runs.append(PredictionRun(0, seqlen - 1, incomp[id(g)]))

    # prediction intervals (extrinsicinfo.cc:1430-1490)
    num_genes = len(genes)
    max_gene_len = 1
    for ag in genes:
        ln = ag.max_trans_end() - ag.min_trans_begin() + 1
        max_gene_len = max(max_gene_len, ln)
    minpadding = (4 * 4000 + num_genes * max_gene_len) // (4 + num_genes) // 2

    out = []
    for run in runs:
        G = causing_groups(run, incomp, stronger, sh.groups)
        if not G:
            continue
        begin = min(g.begin for g in G)
        end = max(g.end for g in G)
        for ag in genes:
            if ag.max_trans_end() >= begin and ag.min_trans_begin() < begin:
                begin = ag.min_trans_begin()
            if ag.min_trans_begin() <= end and ag.max_trans_end() > end:
                end = ag.max_trans_end()
        begin -= minpadding
        end += minpadding
        begin = (begin // 10) * 10       # sync with ttsSpacing
        end = (end // 10 + 1) * 10
        begin = max(begin, 0)
        end = min(end, seqlen - 1)
        if end < begin:
            continue
        run.begin, run.end = begin, end
        out.append(run)
    return out


def causing_groups(run: PredictionRun, incomp, stronger,
                   groups: List[HintGroup]) -> List[HintGroup]:
    """G(R): groups whose incompatible set equals the run's omitted set
    (reference getCausingGroups)."""
    if run.all_hints:
        return list(groups)
    omitted_ids = {id(g) for g in (run.omitted or [])}
    out = []
    for g in groups:
        if {id(o) for o in incomp[id(g)]} == omitted_ids and \
                id(g) not in omitted_ids:
            out.append(g)
    return out
