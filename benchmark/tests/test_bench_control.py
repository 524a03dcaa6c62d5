"""The control: the reference with its Viterbi planes in bfloat16, put in
the program's place, differs from the float32 reference (the control of
`gff_lines_differing`, at a size a test run holds)."""

from benchlib import generator as g
from benchlib import correct
from benchlib.spec import ROOT
import os


def test_bf16_reference_is_not_correct():
    seq = g.read_fasta(os.path.join(g.SEQ_DIR, "HS04636.fa"))[0][1]
    letters = "ACGT" * 100 + seq.upper() + "TGCA" * 100
    job = {"config_path": os.path.join(ROOT, "benchmark", "augustus_config"),
           "options": {"species": "repo_fixture", "UTR": "off",
                       "softmasking": "0"},
           "hints_path": None, "name": "w", "letters": letters, "begin": 0,
           "control": None}
    plain, low = correct.run_reference([job, dict(job, control="bf16")], 2)
    assert any(l.startswith("# start gene") for l in plain)
    d = correct.differing(correct.reference_lines(plain),
                          correct.reference_lines(low))
    assert d > 0
