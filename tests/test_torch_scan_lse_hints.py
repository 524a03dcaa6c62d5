"""K5's plain version against augustus_tpu's make_forward_fn on 6 kb of
tests/data/HS04636.fa softmasked with its EST hints (sparse exon hints,
NHW > 0: the hint quotient), with the UTR fixture: the tests of
tests/test_torch_scan_lse.py on this chunk, a file of its own so that the
test workers share the two (each about two minutes on one CPU core)."""

import pytest

from test_torch_scan_lse import (  # noqa: F401  (collected here)
    make_case, test_engine_table_in_true_log_space,
    test_forward_rows_within_tolerance, test_tables_and_heat_equal)


@pytest.fixture(scope="module")
def case():
    c = make_case("hinted", "HS04636sm.fa", "HS04636sm.E.gff", 0)
    assert c["fe"].static.NHW > 0
    return c
