"""Scaffold a new species config directory (reference scripts/new_species.pl).

Copies the generic template parameter files, substituting the species name,
so etraining can write the species' .pbl files next to them.

Port of `augustus_tpu/training/new_species.py`: host numpy, no kernel.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def create_species(species: str, config_path: str,
                   silent: bool = False) -> str:
    """Create config/species/<species>/ from the generic template; returns
    the new directory path."""
    src_dir = os.path.join(config_path, "species", "generic")
    dst_dir = os.path.join(config_path, "species", species)
    if not os.path.isdir(src_dir):
        raise FileNotFoundError("template directory not found: " + src_dir)
    os.makedirs(dst_dir, exist_ok=True)
    for fname in sorted(os.listdir(src_dir)):
        src = os.path.join(src_dir, fname)
        if not os.path.isfile(src):
            continue
        out_name = fname.replace("generic", species)
        dst = os.path.join(dst_dir, out_name)
        if fname == "generic_parameters.cfg":
            # per-line: substitute the first 'generic', drop the template
            # remark (reference scripts/new_species.pl:126-130)
            with open(src) as fh:
                lines = fh.readlines()
            with open(dst, "w") as fh:
                for line in lines:
                    line = line.replace("generic", species, 1)
                    line = line.replace(
                        "use as template for your own species", "")
                    fh.write(line)
        else:
            with open(src, "rb") as fh:
                data = fh.read()
            with open(dst, "wb") as fh:
                fh.write(data)
    if not silent:
        print("created species directory %s" % dst_dir)
        print("Now train the parameters with the etraining equivalent:\n"
              "  python -m augustus_tpu_torch.cli.etraining train.gb "
              "--species=%s" % species)
    return dst_dir


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    species: Optional[str] = None
    config_path = os.environ.get("AUGUSTUS_CONFIG_PATH", "")
    for a in argv:
        if a.startswith("--species="):
            species = a.split("=", 1)[1]
        elif a.startswith("--AUGUSTUS_CONFIG_PATH="):
            config_path = a.split("=", 1)[1]
    if not species:
        print("usage: new_species --species=NAME "
              "[--AUGUSTUS_CONFIG_PATH=DIR]", file=sys.stderr)
        return 1
    create_species(species, config_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
