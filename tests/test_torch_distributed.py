"""parallel/distributed.py on the CPU: two gloo processes, each decoding
its block of the four pieces of HS04636.fa (--maxDNAPieceSize=3000, the
47-state repo_fixture, softmasked with its EST hints so that the host
state of the hints is gathered too), give every piece the path and hint
state of a single-process decode_pieces.  The processes have a
process-group timeout and the test a subprocess timeout, so nothing
hangs the suite."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from augustus_tpu_torch.parallel import distributed, mesh

from torch_distributed_worker import spec_inputs, summary
from torch_pieces import CONFIG, DATA, HINTS, blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
SPEC = {"args": {"species": "repo_fixture", "AUGUSTUS_CONFIG_PATH": CONFIG,
                 "UTR": "off", "softmasking": "1",
                 "hintsfile": os.path.join(HINTS, "HS04636sm.E.gff"),
                 "extrinsicCfgFile": "extrinsic.M.RM.E.W.cfg"},
        "fasta": os.path.join(DATA, "HS04636sm.fa"), "length": None,
        "pieces": blocks(9453)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n,world", [(4, 2), (3, 2), (1, 2), (5, 3)])
def test_blocks_cover_the_pieces_in_order(n, world):
    got = [list(distributed.block(n, world, r)) for r in range(world)]
    assert [i for b in got for i in b] == list(range(n))
    assert max(map(len, got)) == -(-n // world)


def test_two_processes_equal_one(tmp_path):
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(SPEC))
    out = tmp_path / "out.json"
    addr = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    worker = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, addr, "2", str(r),
                               str(out), "cpu", str(spec_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    got = json.loads(out.read_text())
    model, pieces = spec_inputs(SPEC)
    want = summary(mesh.decode_pieces(model, pieces, "cpu"))
    assert got == want
    assert all(w["has_hints"] for w in want) and \
        sum(w["groups"] for w in want) > 3
