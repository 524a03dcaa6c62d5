#!/usr/bin/env python3
"""How far each in-repo species and hint set stands from the capacity
limits of the kernels K1 (csrc/viterbi.cu), K3 (csrc/forward.cu), K2
(csrc/scan.cu) and K5 (csrc/scan_lse.cu, K2's descriptor and layout), on
the CPU (static sizes, no card).  One JSON line per input: the hint slots
per conv, K1's descriptor ints and shared bytes (k1_refusal's reason, if
any), the widest lessD window, K2's states, segments, descriptor ints in
shared memory and bytes, and whether it takes the deep layout.

    python3 scripts/capacity_report.py
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(name, args, fasta, n=None):
    from augustus_tpu_torch.engine import scan as S
    from augustus_tpu_torch.engine import viterbi as V
    from augustus_tpu_torch.engine.device import build_tracks
    from augustus_tpu_torch.engine.pack import pack_tracks
    from augustus_tpu_torch.io.fasta import read_fasta
    from augustus_tpu_torch.predict import Model, piece_scan
    m = Model.load(dict(args))
    rec = read_fasta(fasta)[0]
    st, t, v0, gold = piece_scan(m, rec, n, "cpu")
    row = {"input": name, "n": st.n, "S": st.S, "NL": st.NL,
           "cross_slots": max([len(c.hint.cross_cols) for c in st.convs
                               if c.hint] + [0]),
           "exact_slots": max([len(c.hint.ex_cols) for c in st.convs
                               if c.hint] + [0]),
           "lessd_window": max([d.window for d in st.lessd] + [0]),
           "k2_segments": len(S.segments(st))}
    desc, _ = S._check(st, t, v0)[1]
    row.update(k2_desc_shared=int(desc[S.D_SHARE_AT]),
               k2_desc=int(desc.size), k2_bytes=int(desc[S.D_BYTES_AT]),
               k2_deep=bool(desc[S.D_DEEP_AT]))
    if st.S <= 64:
        pst, parr = pack_tracks(build_tracks(gold))
        sel, nxh, nxi = V.packed_widths(parr)
        d1 = V._descriptor(pst, sel, nxh, nxi, check=False)
        row.update(k1_variants=max(len(c.variants) for c in pst.convs),
                   k1_desc=int(d1.shape[0]),
                   k1_bytes=V.smem_layout(pst, d1.shape[0], nxh, nxi,
                                          check=False)["bytes"],
                   k1_refusal=V.k1_refusal(pst, sel, nxh, nxi))
    print(json.dumps(row), flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch
    torch.set_num_threads(1)
    import chip_smoke as cs
    from torch_capacity_fixtures import capacity_run
    from torch_nc_check import MULTI, nc_run
    data = cs.DATA
    runs = [("HS04636 repo_fixture", cs.model_args("repo_fixture"),
             os.path.join(data, "HS04636.fa")),
            ("HS04636sm.E repo_fixture", cs.model_args(
                "repo_fixture", "HS04636sm.E.gff"),
             os.path.join(data, "HS04636sm.fa")),
            ("HS04636rc.E repo_fixture", cs.model_args(
                "repo_fixture", "HS04636rc.E.gff"),
             os.path.join(data, "HS04636rc.fa")),
            ("HS04636sm.E repo_fixture_utr", dict(cs.model_args(
                "repo_fixture_utr", "HS04636sm.E.gff"), **cs.UTR_PRINT),
             os.path.join(data, "HS04636sm.fa")),
            ("HS04636 repo_fixture_wide",
             cs.model_args("repo_fixture_wide"),
             os.path.join(data, "HS04636.fa"))]
    for key in cs.NC_RUNS:
        runs.append((key, cs.nc_args(key),
                     os.path.join(data, cs.NC_RUNS[key][2])))
    with tempfile.TemporaryDirectory() as tmp:
        for which in MULTI:
            args, fasta = nc_run(which, tmp)
            runs.append((which, args, fasta))
        for which in ("slots", "deep"):
            for species in ("repo_fixture", "repo_fixture_utr"):
                args, fasta = capacity_run(which, tmp, species)
                runs.append((f"capacity_{which} {species}", args, fasta))
        for name, args, fasta in runs:
            report(name, args, fasta, 20000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
