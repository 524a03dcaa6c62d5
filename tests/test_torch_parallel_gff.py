"""The GFF of a sequence cut into pieces: the port's predict_sequence on
the CPU with --pieceParallel true (the pieces decoded in flight,
parallel/mesh.py) and false (one after another) against augustus_tpu's
predict_sequence, which takes its mesh's decode_pieces on tier-1's 8
virtual CPU devices: HS04636.fa with the 47-state repo_fixture at
--maxDNAPieceSize=3000 (four pieces)."""

import os

import pytest
import torch

from augustus_tpu.predict import Model as JModel
from augustus_tpu.predict import predict_sequence as jpredict
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.parallel import mesh
from augustus_tpu_torch.predict import Model, predict_sequence

from torch_pieces import CONFIG, DATA

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)
ARGS = {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
        "UTR": "off", "softmasking": "0", "maxDNAPieceSize": "3000"}


@pytest.fixture(scope="module")
def texts():
    from augustus_tpu.io.fasta import read_fasta as jread
    fasta = os.path.join(DATA, "HS04636.fa")
    out = {}
    for flag in ("true", "false"):
        mesh.decode_pieces.last = None
        model = Model.load(dict(ARGS, pieceParallel=flag))
        out[flag] = predict_sequence(model, read_fasta(fasta)[0],
                                     device="cpu")[0]
        out[flag + "_batches"] = mesh.decode_pieces.last
    out["reference"] = jpredict(JModel.load(dict(ARGS)), jread(fasta)[0],
                                engine="auto")[0]
    return out


def test_piece_parallel_takes_the_batched_decode(texts):
    assert texts["true_batches"]["ctas"][0] == {"kernel": "viterbi_forward",
                                                "blocks": 4}
    assert texts["false_batches"] is None


@pytest.mark.parametrize("flag", ["true", "false"])
def test_gff_equal_to_reference(texts, flag):
    assert texts[flag] == texts["reference"]
    assert texts[flag].count("\tgene\t") >= 1
