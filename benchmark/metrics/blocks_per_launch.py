"""Pieces in flight: the mean number of blocks (pieces) of the batched K1
launches of parallel/mesh.decode_pieces (its `last` record of each
sequence cut into pieces)."""


def read(r):
    blocks = [c["blocks"] for p in r.pieces for c in p["ctas"]
              if c["kernel"].startswith("viterbi_forward")]
    return sum(blocks) / len(blocks) if blocks else None
