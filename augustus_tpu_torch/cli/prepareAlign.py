"""prepareAlign CLI entry: filter an MSA to sequences covering most
gapless blocks (reference auxprogs — prepareAlign; PPX workflow
docs/RUNNING-AUGUSTUS.md:497).  Reads FASTA MSA from stdin, writes the
filtered MSA to stdout; see ppx/prepare_align.py for the env-variable
knobs (PA_FULL_COL_WEIGHT, PA_SKIP_COL_WEIGHT, PA_MINSIZE, ...).

Host copy of `augustus_tpu/cli/prepareAlign.py`:
the same iteration orders, float formats and output text; it runs no
kernel.
"""
import sys

from ..ppx.prepare_align import main

if __name__ == "__main__":
    sys.exit(main())
