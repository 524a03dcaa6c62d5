"""The deep capacity input on the 71-state species repo_fixture_utr
(--UTR=on): K2 (its plain version here) with the GFF equal to the
committed golden, the port's own CPU path (see
test_torch_capacity_deep.py)."""

from test_torch_capacity_deep import deep_gff_equal_to_golden


def test_deep_utr_piece_gff_equal_to_golden(tmp_path):
    deep_gff_equal_to_golden(tmp_path, "repo_fixture_utr",
                             "repo_fixture_utr_capacity_deep.gff")
