"""The plain reference against the port on the CPU, and the faults that
must make `correct` false.  Each test drives benchmark/run.py's `run` with
the port's plain versions (device cpu) on small records: one of 24,000
bases cut into pieces of at most 12,000 (so that windows begin at a cut
point that the program's exam chose), or one of 10,000 bases in one
piece."""

import pytest

import run as R
from benchlib import spec as S

CELL = "fly47.chrom"


def tiny(cut: bool):
    """(configuration, mix): the cell's, at a size a test holds."""
    sp = S.load_spec()
    cfg = S.config(sp, S.cell(sp, CELL)["config"])
    mix = S.traffic(S.cell(sp, CELL)["traffic"])
    mix["spacer"] = [300, 1200]
    mix["warmup"] = {"length": 2000}
    if cut:
        cfg["options"] = dict(cfg["options"], maxDNAPieceSize="12000")
        mix["lengths"] = {"fixed": 24000, "count": 1}
        mix["check"] = {"windows": 4, "bare": 1, "min": 2000,
                        "max": 10000, "margin": 300, "at_cuts": 1}
    else:
        mix["lengths"] = {"fixed": 10000, "count": 1}
        mix["check"] = {"windows": 2, "min": 2500, "max": 9000,
                        "margin": 300}
    return cfg, mix


def run_cpu(cut: bool, fault=None, seed: int = 3):
    cfg, mix = tiny(cut)
    args = R.parse(["--workload", CELL, "--seed", str(seed),
                    "--seconds", "0", "--trace", "0"])
    return R.run(args, device="cpu", cfg=cfg, mix=mix, fault=fault)


def test_reference_agrees_with_the_port_from_each_cut():
    line, d = run_cpu(True)
    assert d["windows_at_cuts"] >= 1 and d["windows"] > d["windows_at_cuts"]
    assert d["genes"] >= 2
    assert d["gff_lines_differing"] == 0
    assert d["transcripts"] >= 2 and d["transcripts_malformed"] == 0
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"gff_lines_differing",
                                   "transcripts_malformed", "windows",
                                   "windows_at_cuts"}


def _alter_output(edit):
    def fault(cell):
        plain = cell.call
        cell.call = lambda rec: edit(plain(rec))
    return fault


def _shift_cds(text, after=0):
    """The end of the first CDS that begins past `after` moved by 3."""
    out, done = [], False
    for line in text.splitlines(keepends=True):
        c = line.split("\t")
        if not done and len(c) >= 9 and c[2] == "CDS" and int(c[3]) > after:
            c[4] = str(int(c[4]) + 3)
            line, done = "\t".join(c), True
        out.append(line)
    return "".join(out)


def _drop_first_gene(text):
    out, skip = [], False
    for line in text.splitlines(keepends=True):
        if line.startswith("# start gene") and not skip and \
                "dropped" not in out:
            skip = True
            out.append("dropped")
        if not skip:
            out.append(line)
        if skip and line.startswith("# end gene"):
            skip = False
    return "".join(x for x in out if x != "dropped")


def _alter_protein(text):
    """One letter of the first printed protein changed."""
    k = text.index("# protein sequence = [") + len("# protein sequence = [")
    return text[:k] + ("W" if text[k] != "W" else "C") + text[k + 1:]


def _viterbi_in_bf16(cell):
    import torch
    from augustus_tpu_torch.engine import viterbi
    plain = viterbi.viterbi_forward_reference

    def low(static, planes, debug_vals=False):
        return plain(static, {k: (v.to(torch.bfloat16).to(v.dtype)
                                  if v.is_floating_point() else v)
                              for k, v in planes.items()}, debug_vals)
    viterbi.viterbi_forward_reference = low


@pytest.mark.parametrize("fault", ["answer_altered", "gene_left_out",
                                   "viterbi_in_bf16", "protein_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    plant = {"answer_altered": _alter_output(_shift_cds),
             "gene_left_out": _alter_output(_drop_first_gene),
             "viterbi_in_bf16": _viterbi_in_bf16,
             "protein_altered": _alter_output(_alter_protein)}[fault]
    from augustus_tpu_torch.engine import viterbi
    plain = viterbi.viterbi_forward_reference
    try:
        # a gene left out: on the record in pieces, whose windows reach
        # past the next gene
        line, d = run_cpu(fault == "gene_left_out", plant)
    finally:
        viterbi.viterbi_forward_reference = plain
    assert line["correct"] is False
    if fault in ("answer_altered", "protein_altered"):
        assert d["transcripts_malformed"] > 0
    if fault != "protein_altered":
        assert d["gff_lines_differing"] > 0


def test_a_fault_past_the_first_cut_is_not_correct():
    """A CDS end moved in the second piece only: the window at the cut
    and the letters both see it."""
    from augustus_tpu_torch import predict
    plain_cut = predict.cut_pieces
    cut = {}

    def fault(cell):
        plain = cell.call

        def call(rec):
            out = plain(rec)
            cut["at"] = cell._cut[1][0] + 1
            return _shift_cds(out, after=cut["at"])
        cell.call = call
    try:
        line, d = run_cpu(True, fault)
    finally:
        predict.cut_pieces = plain_cut
    assert d["transcripts_malformed"] > 0
    assert d["gff_lines_differing"] > 0
    assert line["correct"] is False
