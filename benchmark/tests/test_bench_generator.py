"""The traffic generator is deterministic per seed."""

from benchlib import generator as g
from benchlib import spec as S


# a softmasked, hinted mix of log-uniform lengths, as a later mix's data
# file would give it (the generator reads every key of it)
HINTED = {"lengths": {"loguniform": [20000, 80000], "count": 3, "sets": 2},
          "spacer": [2000, 20000],
          "softmask": {"gap": [100, 4550], "run": [100, 3000]},
          "hints": {"signals_every": 2,
                    "drop": ["exonpart", "CDSpart", "exon", "CDS"]},
          "warmup": {"length": 20000}}


def _mix(name):
    if name == "hinted":
        return dict(HINTED)
    mix = S.traffic(name)
    mix["lengths"] = dict(mix["lengths"], count=3, fixed=60000)
    return mix


def test_same_seed_same_records():
    for name in ("chrom", "hinted"):
        mix = _mix(name)
        a = g.make_records(mix, 2**31 + 11)
        b = g.make_records(mix, 2**31 + 11)
        assert [(r.name, r.sequence, r.hints) for r in a] == \
            [(r.name, r.sequence, r.hints) for r in b]


def test_other_seed_other_records_same_lengths():
    for name in ("chrom", "hinted"):
        mix = _mix(name)
        a = g.make_records(mix, 5)
        b = g.make_records(mix, 6)
        assert [r.sequence for r in a] != [r.sequence for r in b]
        assert sorted(len(r.sequence) for r in a) == \
            sorted(len(r.sequence) for r in b)


def test_negative_and_large_seeds():
    mix = _mix("chrom")
    assert g.make_records(mix, -3)[0].sequence != \
        g.make_records(mix, 3)[0].sequence
    assert len(g.make_records(mix, 2**40)[0].sequence) == 60000


def test_a_hinted_mix_is_softmasked_with_intron_kind_hints_only():
    mix = _mix("hinted")
    recs = g.make_records(mix, 17)
    letters = "".join(r.sequence for r in recs)
    low = sum(c.islower() for c in letters) / len(letters)
    assert 0.3 < low < 0.5
    kinds = {h.split("\t")[2] for r in recs for h in r.hints}
    assert kinds and not kinds & {"exonpart", "CDSpart", "exon", "CDS"}
    for r in recs:
        for h in r.hints:
            c = h.split("\t")
            assert c[0] == r.name and 1 <= int(c[3]) <= int(c[4]) <= \
                len(r.sequence)


def test_chrom_is_unmasked_without_hints():
    recs = g.make_records(_mix("chrom"), 17)
    assert all(r.sequence.isupper() and not r.hints for r in recs)
