"""CLI entry point of the PyTorch/CUDA port: etraining equivalent.

Usage: python -m augustus_tpu_torch.cli.etraining trainset.gb --species=X \
           [--AUGUSTUS_CONFIG_PATH=DIR] [--device=cpu|cuda] [--key=value ...]

Port of `augustus_tpu/cli/etraining.py`.  Writes the species' .pbl files
into DIR/species/X/ (make the species with training/new_species.py);
--CRF=on [--CRF_N=rounds] then predicts every training gene on --device
(default cuda) in each round and rewrites the exon and intron files, the
maximum-likelihood ones kept as .pbl.HMM.
"""

import sys

from ..training.etraining import main

if __name__ == "__main__":
    sys.exit(main())
