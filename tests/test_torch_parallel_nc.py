"""Pieces in flight on the CPU through K2 with the ncRNA architecture
(--nc=on, 83 states, tests/data/nc_hints.gff): the port's decode_pieces
on the four pieces of HS04636.fa at --maxDNAPieceSize=2500 (at 3,000 the
noncoding transcript at 9,000-9,200 would open the last, 453-base piece,
which predicts none; at 2,500 the last piece holds it) against
augustus_tpu's parallel.mesh.decode_pieces, which decodes nc pieces with
its host GoldEngine (its device tracks refuse them).  Only the segments
are compared: augustus_tpu's gene projection does not return on an nc exon
(ROADMAP queue 3), as tests/torch_nc_check.py explains."""

import torch

from augustus_tpu.predict import Model as JModel
from augustus_tpu_torch.parallel import mesh
from augustus_tpu_torch.predict import Model

from torch_nc_check import nc_run
from torch_pieces import key, piece_inputs, reference_paths

# The plain versions run a Python loop of small torch ops; an OpenMP pool
# of several threads spins between them and starves the other test workers.
torch.set_num_threads(1)


def test_segments_equal_to_reference():
    args, fasta = nc_run("nc_hints")
    model = Model.load(dict(args))
    got = mesh.decode_pieces(model, piece_inputs("augustus_tpu_torch", model,
                                                 fasta, 2500), "cpu")
    assert mesh.decode_pieces.last["ctas"][0] == {"kernel": "scan_forward",
                                                  "blocks": 4}
    jmodel = JModel.load(dict(args))
    want = reference_paths(jmodel, piece_inputs("augustus_tpu", jmodel,
                                                 fasta, 2500))
    assert [key(path) for path, _ in got] == want
    assert sum(len(w) for w in want) > 4    # not only intergenic pieces
