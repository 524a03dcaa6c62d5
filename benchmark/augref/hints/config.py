"""Extrinsic (hints) configuration: config/extrinsic/extrinsic.cfg parsing.

reference: FeatureCollection::readExtrinsicCFGFile / readTypeInfo
(src/extrinsicinfo.cc:2044-2120), FeatureTypeInfo (include/extrinsicinfo.hh:258).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the 17 hint feature types (reference include/hints.hh:31)
FEATURE_TYPES = [
    "start", "stop", "ass", "dss", "tss", "tts", "exonpart", "exon",
    "intronpart", "intron", "irpart", "CDS", "CDSpart", "UTR", "UTRpart",
    "nonexonpart", "genicpart",
]


@dataclass
class TypeInfo:
    bonus: float = -1.0          # -1 = uninitialized (individual bonus)
    malus: float = 1.0
    local_malus: float = 1.0
    # per-source grade class bounds and quotients
    gradeclassbounds: Dict[str, List[float]] = field(default_factory=dict)
    gradequots: Dict[str, List[float]] = field(default_factory=dict)

    def gradeclass(self, source: str, score: float) -> int:
        bounds = self.gradeclassbounds.get(source, [])
        k = 0
        while k < len(bounds) and score >= bounds[k]:
            k += 1
        return k

    def gradequot(self, source: str, score: float) -> float:
        quots = self.gradequots.get(source, [1.0])
        return quots[self.gradeclass(source, score)]


@dataclass
class ExtrinsicConfig:
    sources: List[str] = field(default_factory=lambda: ["M"])
    type_info: Dict[str, TypeInfo] = field(default_factory=dict)
    individual_liability: Dict[str, bool] = field(default_factory=dict)
    one_group_one_gene: Dict[str, bool] = field(default_factory=dict)

    def info(self, type_name: str) -> TypeInfo:
        if type_name not in self.type_info:
            self.type_info[type_name] = TypeInfo()
        return self.type_info[type_name]

    def malus(self, type_name: str) -> float:
        return self.info(type_name).malus

    def bonus_for(self, type_name: str, source: str, score: float) -> float:
        """General bonus × grade quotient (reference setBonusMalus,
        extrinsicinfo.cc:2309); -1 means individual bonus (use score)."""
        ti = self.info(type_name)
        if ti.bonus < 0:
            return score if score > 0 else 1.0
        return ti.bonus * ti.gradequot(source, score)


def read_extrinsic_cfg(path: str) -> ExtrinsicConfig:
    cfg = ExtrinsicConfig()
    with open(path) as fh:
        lines = [l.split("#", 1)[0].strip() for l in fh]
    lines = [l for l in lines if l]
    sec = None
    for line in lines:
        if line.startswith("["):
            sec = line.strip("[]")
            continue
        toks = line.split()
        if sec == "SOURCES":
            cfg.sources = toks
        elif sec == "SOURCE-PARAMETERS":
            src = toks[0]
            for t in toks[1:]:
                if t == "individual_liability":
                    cfg.individual_liability[src] = True
                elif t == "1group1gene":
                    cfg.one_group_one_gene[src] = True
        elif sec == "GENERAL":
            name = toks[0]
            ti = cfg.info(name)
            ti.bonus = float(toks[1])
            ti.malus = float(toks[2])
            i = 3
            # optional local malus (reference readTypeInfo reads it when the
            # next token is numeric)
            try:
                ti.local_malus = float(toks[3])
                i = 4
            except (ValueError, IndexError):
                pass
            while i < len(toks):
                src = toks[i]
                ncls = int(toks[i + 1])
                bounds = [float(x) for x in toks[i + 2: i + 1 + ncls]]
                quots = [float(x)
                         for x in toks[i + 1 + ncls: i + 1 + 2 * ncls]]
                ti.gradeclassbounds[src] = bounds
                ti.gradequots[src] = quots
                i += 1 + 2 * ncls
    return cfg


def default_config_path(props) -> Optional[str]:
    """reference properties.cc:436: default extrinsic.cfg under config/."""
    if "extrinsicCfgFile" in props:
        p = props.get("extrinsicCfgFile")
        if os.path.exists(p):
            return p
        alt = os.path.join(props.config_path, "extrinsic", p)
        if os.path.exists(alt):
            return alt
    p = os.path.join(props.config_path, "extrinsic", "extrinsic.cfg")
    return p if os.path.exists(p) else None
