"""The ncRNA decode (--nc=on, 83 states) of the port held against
augustus_tpu's host float64 engine on one piece.

augustus_tpu decodes nc pieces only with `GoldEngine.run` (its device
engines refuse nc states), so that table is the reference: `gold_engine`
and `port_scan` decode the whole input as one piece, the port on
`_decode`'s route (host prep, device tracks, K2's plain version on the
CPU) with K2's values kept; `compare` holds the port's values at live
states (rebased values plus the igenic base) to gold's within `tol` and,
wherever gold's best candidate leads its runner-up of another
(predecessor, end) by more than `tol`, the port's backpointer to gold's.
"""

import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
NC_ARGS = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
           "UTR": "on", "nc": "on", "softmasking": "0", "print_utr": "on"}
# the float32 tolerance of the port's Viterbi values against gold's float64
# table at live states: the largest difference measured was 8.65e-3 (the
# hint fixture; 3.07e-3 on nc_hints, 5.0e-4 without hints; PERF.md
# section 6), at values up to 1.3e4 in magnitude
TOL = 2e-2


# the nc inputs whose intron hints end at one base with several starts
MULTI = ("nc_two_starts", "nc_alt_donors")
ALT_SEED = 20161
MULTI_DIR = os.path.join(ROOT, "build", "nc_multi")


def write_multi_hints(which: str, dst: str = None) -> str:
    """The hint file of a MULTI input, written into dst: the hint fixture
    HS08198.nc.gff with, for nc_two_starts, a copy of its first intron hint
    that starts 30 bases earlier; for nc_alt_donors, after every intron
    hint two seeded copies of the same end whose start moves by 8-60 bases
    either way (alternative donors of one acceptor on the forward strand,
    alternative acceptors of one donor on the reverse)."""
    import numpy as np
    with open(os.path.join(HINTS, "HS08198.nc.gff")) as fh:
        lines = fh.read().splitlines(True)
    out = list(lines)
    if which == "nc_two_starts":
        first = next(l.split("\t") for l in lines if "\tintron\t" in l)
        extra = list(first)
        extra[3] = str(int(first[3]) - 30)
        out.append("\t".join(extra))
    elif which == "nc_alt_donors":
        rng = np.random.RandomState(ALT_SEED)
        out = []
        for l in lines:
            out.append(l)
            f = l.split("\t")
            if len(f) < 9 or f[2] != "intron":
                continue
            for _ in range(2):
                shift = int(rng.randint(8, 61)) * (1 if rng.rand() < 0.5
                                                   else -1)
                g = list(f)
                g[3] = str(int(f[3]) + shift)
                out.append("\t".join(g))
    else:
        raise ValueError(which)
    dst = dst or MULTI_DIR
    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, f"HS08198.{which}.gff")
    with open(path, "w") as fh:
        fh.write("".join(out))
    return path


def nc_run(which: str, dst: str = None):
    """(arguments, FASTA path) of an nc input: HS04636.fa with the tss / tts
    / exon hints of tests/data/nc_hints.gff, HS08198.fa without hints,
    HS08198.fa with the hint fixture HS08198.nc.gff, and HS08198.fa with
    the hint files of write_multi_hints (written into dst, by default
    MULTI_DIR)."""
    if which in MULTI:
        return (dict(NC_ARGS, hintsfile=write_multi_hints(which, dst),
                     extrinsicCfgFile="extrinsic.M.RM.E.W.nc.cfg"),
                os.path.join(DATA, "HS08198.fa"))
    if which == "nc_hints":
        return (dict(NC_ARGS, hintsfile=os.path.join(DATA, "nc_hints.gff"),
                     extrinsicCfgFile="extrinsic.M.RM.E.W.cfg"),
                os.path.join(DATA, "HS04636.fa"))
    if which == "nc_plain":
        return dict(NC_ARGS), os.path.join(DATA, "HS08198.fa")
    if which == "nc_fixture":
        return (dict(NC_ARGS,
                     hintsfile=os.path.join(HINTS, "HS08198.nc.gff"),
                     extrinsicCfgFile="extrinsic.M.RM.E.W.nc.cfg"),
                os.path.join(DATA, "HS08198.fa"))
    raise ValueError(which)


def _codes_and_hints(model, fasta):
    from augustus_tpu_torch import genetics
    from augustus_tpu_torch.io.fasta import read_fasta
    rec = list(read_fasta(fasta))[0]
    hints = model.gff_hints.get(rec.name) if model.gff_hints else None
    return genetics.encode(rec.sequence), hints


def gold_engine(which: str, run: bool = True):
    """augustus_tpu's GoldEngine of the input as one piece, prepared, and
    with run=True decoded (its .v, .bp_state, .bp_base)."""
    from augustus_tpu.engine.gold import GoldEngine
    from augustus_tpu.predict import Model
    args, fasta = nc_run(which)
    jm = Model.load(dict(args))
    codes, hints = _codes_and_hints(jm, fasta)
    g = GoldEngine(jm.sg, jm.cn, jm.igp, jm.exp, jm.inp, jm.decomp, jm.gcode,
                   utr=jm.utr, utr_cfg=jm.utr_cfg, ext_cfg=jm.ext_cfg)
    g.set_boundaries(True, True)
    if run:
        g.run(codes, gff_hints=hints)
    else:
        g.prepare(codes, gff_hints=hints)
    return g


def port_gold(which: str):
    """The port's GoldEngine of the input as one piece, prepared (host
    route)."""
    from augustus_tpu_torch.predict import Model, _new_gold
    args, fasta = nc_run(which)
    m = Model.load(dict(args))
    codes, hints = _codes_and_hints(m, fasta)
    g = _new_gold(m, True, True)
    g.collect_hints(codes, None, hints)
    g.prepare_collected()
    return g


def port_scan(which: str):
    """(GoldEngine, DPTracks, ScanEngine) of the port on the input as one
    piece, K2's plain version run with its values kept."""
    from augustus_tpu_torch.engine.device import build_tracks
    from augustus_tpu_torch.engine.scan import ScanEngine, needs_general_scan
    g = port_gold(which)
    tr = build_tracks(g)
    assert needs_general_scan(tr)
    eng = ScanEngine(tr, torch.device("cpu"))
    eng.run(debug_vals=True)
    return g, tr, eng


def compare(gold, tr, eng, tol: float = TOL, states=None):
    """Hold the port's K2 values and backpointers to gold's table.  Returns
    (largest |dv| at live states, live entries compared, backpointers
    compared, the (position, state) pairs whose gap to the runner-up was
    within tol, so that their backpointers were not compared)."""
    from augustus_tpu_torch.engine.scan import GATE
    vals = eng.vals.cpu().numpy().astype(np.float64)
    v = vals + np.asarray(tr.base, np.float64)[:, None]
    v[0] = vals[0]
    live_p = vals > float(GATE)
    live_g = gold.v > -np.inf
    assert (live_p == live_g).all(), np.argwhere(live_p != live_g)[:5]
    dv = np.abs(np.where(live_g, v - gold.v, 0.0))
    worst = float(dv.max())
    assert worst <= tol, (worst, np.unravel_index(dv.argmax(), dv.shape))
    bp = eng.bp.cpu().numpy().astype(np.int64)
    types = gold.sg.state_types
    S = gold.S
    states = range(S) if states is None else states
    checked, ties = 0, []
    for s in states:
        for j in np.flatnonzero(live_g[:, s])[1:]:
            j = int(j)
            c = int(gold.stairs[j])
            got = gold._state_cands(j, c, s, gold.v)
            w, pred, eop = got
            order = np.argsort(-w, kind="stable")
            b = order[0]
            second = next((k for k in order[1:]
                           if (pred[k], eop[k]) != (pred[b], eop[b])), None)
            gap = np.inf if second is None else w[b] - w[second]
            if gap <= tol:
                ties.append((j, s))
                continue
            checked += 1
            assert (bp[j, s] >> 20, j - (bp[j, s] & 0xFFFFF)) == \
                (gold.bp_state[j, s], gold.bp_base[j, s]), \
                (j, types[s].name, bp[j, s] >> 20, j - (bp[j, s] & 0xFFFFF),
                 gold.bp_state[j, s], gold.bp_base[j, s])
    return worst, int(live_g.sum()), checked, ties


def main() -> int:
    """Print, for each nc input, the largest |dv| at live states, the live
    entries, the nc backpointers compared and those within the tolerance
    (PERF.md section 6 quotes these lines)."""
    import json
    import time
    torch.set_num_threads(1)
    for which in ("nc_plain", "nc_hints", "nc_fixture") + MULTI:
        t0 = time.perf_counter()
        gold = gold_engine(which)
        t1 = time.perf_counter()
        _, tr, eng = port_scan(which)
        t2 = time.perf_counter()
        nc = [s for s, t in enumerate(gold.sg.state_types) if int(t) >= 74]
        worst, live, checked, ties = compare(gold, tr, eng, TOL, nc)
        print(json.dumps({"input": which, "n": gold.n, "tol": TOL,
                          "max_abs_dv": worst, "live": live,
                          "nc_backpointers_compared": checked,
                          "nc_within_tol": len(ties),
                          "max_abs_v": float(np.abs(np.where(
                              gold.v > -np.inf, gold.v, 0.0)).max()),
                          "gold_run_s": t1 - t0, "port_cpu_s": t2 - t1}),
              flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.path.insert(0, ROOT)
    sys.exit(main())
