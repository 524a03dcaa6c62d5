"""Configuration / flag system.

Mirrors the behavior of the reference three-tier config (CLI > model config >
species config; reference: src/properties.cc, include/properties.hh) with the
same key names, so existing AUGUSTUS config trees (``config/``) can be used
unchanged.  Keys are plain strings such as ``/ExonModel/k`` or ``maxDNAPieceSize``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

TRUE_STRINGS = {"true", "on", "yes", "1", "t"}
FALSE_STRINGS = {"false", "off", "no", "0", "f"}


class PropertiesError(Exception):
    pass


def parse_bool(value: str) -> bool:
    v = value.strip().lower()
    if v in TRUE_STRINGS:
        return True
    if v in FALSE_STRINGS:
        return False
    raise PropertiesError(f"cannot interpret '{value}' as boolean")


def _strip_comment(line: str) -> str:
    # config files use '#' comments; values never contain '#'
    pos = line.find("#")
    if pos >= 0:
        line = line[:pos]
    return line.strip()


@dataclass
class Properties:
    """Global string-keyed configuration store."""

    config_path: str = ""
    store: Dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------------ basic
    def __contains__(self, key: str) -> bool:
        return key in self.store

    def set(self, key: str, value: str) -> None:
        self.store[key] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> str:
        if key in self.store:
            return self.store[key]
        if default is not None:
            return default
        raise PropertiesError(f"no such config key: {key}")

    def get_indexed(self, prefix: str, index: int) -> str:
        """Key families like /NAMGene/state00 .. /NAMGene/state70."""
        return self.get(f"{prefix}{index:02d}")

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if key not in self.store and default is not None:
            return default
        val = self.get(key)
        try:
            return int(val)
        except ValueError:
            # reference uses atoi(): leading integer part, 0 on garbage
            # (e.g. /ExonModel/minPatSum "233.3" -> 233)
            import re
            m = re.match(r"\s*[-+]?\d+", val)
            return int(m.group(0)) if m else 0

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if key not in self.store and default is not None:
            return default
        return float(self.get(key))

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        if key not in self.store and default is not None:
            return default
        return parse_bool(self.get(key))

    # ------------------------------------------------------------------ files
    def read_cfg_file(self, path: str) -> None:
        """Read a ``key value`` per-line config file (overwrites existing keys)."""
        with open(path, "r") as fh:
            for raw in fh:
                line = _strip_comment(raw)
                if not line:
                    continue
                parts = line.split(None, 1)
                if len(parts) == 1:
                    continue
                key, value = parts[0], parts[1].strip()
                self.store[key] = value

    # ------------------------------------------------------------------ paths
    def species_dir(self) -> str:
        species = self.get("species")
        return os.path.join(self.config_path, "species", species)

    def species_file(self, suffix: str) -> str:
        """Path of a per-species file, e.g. suffix='_exon_probs.pbl'."""
        species = self.get("species")
        return os.path.join(self.species_dir(), species + suffix)

    def model_dir(self) -> str:
        return os.path.join(self.config_path, "model")


# extra CLI names accepted although absent from the JSON registry
# (the reference also special-cases some, properties.cc:92-96)
_EXTRA_KEYS = {"species", "AUGUSTUS_CONFIG_PATH", "nc", "queryfile",
               "transfile", "statecfgfile", "paramlist", "help",
               "version", "alnfile", "treefile", "speciesfilenames",
               "dbaccess", "pieceParallel"}


def load_registry(config_path: str):
    """The canonical flag registry
    (config/parameters/aug_cmdln_parameters.json, 344 entries; reference
    Properties::readJSON / checkType, src/properties.cc:560-605).
    Returns {name: entry} or None when the file is absent."""
    import json
    path = os.path.join(config_path, "parameters",
                        "aug_cmdln_parameters.json")
    if not os.path.exists(path):
        return None
    try:
        entries = json.load(open(path))
    except Exception:
        return None
    return {e.get("name"): e for e in entries if isinstance(e, dict)}


def validate_args(args: Dict[str, str], config_path: str) -> None:
    """Validate CLI keys against the registry.

    Mirrors the reference's behavior (properties.cc:585-590): an unknown
    parameter prints an error line on stderr but does not abort; a value
    outside an enumerated possible_values list raises (properties.cc
    isPossibleValue -> ProjectError)."""
    import sys
    reg = load_registry(config_path)
    if reg is None:
        return
    for k, v in args.items():
        if k in _EXTRA_KEYS:
            continue
        e = reg.get(k)
        if e is None:
            sys.stderr.write(f"Error: The parameter {k} is not specified "
                             "in config file.\n")
            continue
        pv = e.get("possible_values")
        if pv and v not in [str(x) for x in pv]:
            raise PropertiesError(
                f"invalid value '{v}' for --{k}; possible values: {pv}")
        ty = e.get("type")
        if ty == "int":
            try:
                int(v)
            except ValueError:
                raise PropertiesError(f"--{k} expects an integer, got '{v}'")
        elif ty in ("float", "double"):
            try:
                float(v)
            except ValueError:
                raise PropertiesError(f"--{k} expects a number, got '{v}'")
        elif ty in ("bool", "boolean"):
            if v.strip().lower() not in TRUE_STRINGS | FALSE_STRINGS:
                raise PropertiesError(f"--{k} expects a boolean, got '{v}'")


def init_properties(args: Dict[str, str],
                    config_path: Optional[str] = None) -> Properties:
    """Build the configuration from CLI-style key/value args.

    Mirrors the reference precedence (src/properties.cc:144-420):
    species parameter file < model state config < command line.
    Also selects the transition file and state architecture config from
    ``genemodel`` / ``UTR`` / ``nc`` / ``singlestrand``
    (src/properties.cc:322-399) and stores it under key ``transfile``.
    """
    props = Properties()
    if config_path is None:
        config_path = args.get("AUGUSTUS_CONFIG_PATH",
                               os.environ.get("AUGUSTUS_CONFIG_PATH", ""))
    if config_path and not config_path.endswith(os.sep):
        config_path = config_path + os.sep
    props.config_path = config_path
    validate_args(args, config_path)

    if "species" not in args:
        raise PropertiesError("No species specified")
    props.set("species", args["species"])

    # 1. species parameter file
    species_cfg = os.path.join(props.species_dir(),
                               args["species"] + "_parameters.cfg")
    props.read_cfg_file(species_cfg)

    # 2. command line (first pass — may set UTR/genemodel used below)
    for k, v in args.items():
        props.set(k, v)

    # 3. architecture selection
    single_strand = props.get_bool("singlestrand", False)
    strand_name = "singlestrand" if single_strand else "shadow"
    genemodel = props.get("genemodel", "partial")
    if genemodel not in ("partial", "complete", "atleastone", "exactlyone",
                         "intronless", "bacterium"):
        raise PropertiesError(f"Unknown genemodel: {genemodel}")
    utr_on = props.get_bool("UTR", False)
    nc_on = props.get_bool("nc", False)
    if nc_on and not utr_on:
        utr_on = True
        props.set("UTR", "on")

    transfile = f"trans_{strand_name}_{genemodel}"
    if utr_on:
        if single_strand or genemodel not in ("partial", "complete"):
            raise PropertiesError("UTR only implemented with shadow and "
                                  "partial or complete")
        transfile += "_utr"
    if nc_on:
        transfile += "_nc"
    transfile += ".pbl"
    props.set("transfile", transfile)

    statecfg = f"states_{strand_name}"
    if genemodel in ("atleastone", "exactlyone"):
        statecfg += "_2igenic"
    elif genemodel == "intronless":
        statecfg += "_intronless"
    elif genemodel == "bacterium":
        statecfg += "_bacterium"
    elif utr_on:
        statecfg += "_utr"
        if nc_on:
            statecfg += "_nc"
    statecfg += ".cfg"

    # 4. model state architecture config
    props.read_cfg_file(os.path.join(props.model_dir(), statecfg))
    props.set("statecfgfile", statecfg)

    # 5. command line again (highest priority; model cfg must not shadow it)
    for k, v in args.items():
        props.set(k, v)

    return props
