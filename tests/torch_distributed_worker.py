"""One rank of a parallel.distributed run, for tests/test_torch_distributed.py
and chip_smoke.py's distributed phase:

    python3 tests/torch_distributed_worker.py ADDR WORLD RANK OUT DEVICE \
        SPEC.json

joins the gloo group at ADDR (host:port) as RANK of WORLD, decodes the
pieces that SPEC describes with decode_pieces_global on DEVICE, and (rank 0)
writes every piece's condensed path and hint state as JSON to OUT.  SPEC:
{"args": model arguments, "fasta": path, "length": bases of its first
record taken (null: all), "pieces": [[begin, end, init_synch,
term_synch], ...]}.  It imports neither jax nor augustus_tpu."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spec_inputs(spec):
    """(model, piece inputs) of a SPEC."""
    from augustus_tpu_torch import genetics
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.io.tiled import tiled_record
    from augustus_tpu_torch.predict import Model, piece_inputs
    model = Model.load(dict(spec["args"]))
    if spec["fasta"] == "tiled":
        rec = tiled_record(os.path.join(ROOT, "tests", "data"))
    else:
        rec = read_fasta(spec["fasta"])[0]
    seq = rec.sequence[: spec["length"]]
    codes = genetics.encode(seq.lower())
    softmask = genetics.softmask_runs(seq)
    hints = model.gff_hints.get(rec.name, []) \
        if model.gff_hints is not None else None
    return model, piece_inputs(codes, softmask, hints, spec["pieces"])


def summary(decoded):
    """What a run's output reads of every piece: its condensed path and
    its hint state."""
    return [{"path": [[s.begin, s.end, int(s.type), s.truncated]
                      for s in path],
             "has_hints": bool(gold.has_hints),
             "groups": len(gold.hints.groups) if gold.hints is not None
             else 0}
            for path, gold in decoded]


def main(addr, world, rank, out, device, spec_path) -> int:
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from augustus_tpu_torch.parallel import distributed
    with open(spec_path) as fh:
        spec = json.load(fh)
    model, pieces = spec_inputs(spec)
    distributed.init(addr, int(world), int(rank), timeout_s=300)
    try:
        got = distributed.decode_pieces_global(model, pieces, device)
        if int(rank) == 0:
            with open(out, "w") as fh:
                json.dump(summary(got), fh)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
