"""The order of K5's sums (csrc/scan_lse.cu) on the CPU.

engine/scan.py keeps a float32 numpy copy of the kernel's combine shapes:
a lane's run in batches (`lse_batch_ref`: the batch's maximum first, one
rescale, the batch's terms in a fixed tree), the merge of a segment's 32
parked pairs by a group of 4 lanes (`merge_parked_ref`), a cut segment's
pieces (`seg_value_ref`), a state's variants on 8 lanes
(`fold_variants_ref`) and phase C's reduce over the states
(`reduce_c_ref`).  Here they go, on seeded scores, through the band list
of the port's 6 kb UTR piece of HS04636.fa as phase A cuts it
(engine/scan.py:k2_shares, the kernel's share arithmetic), and must meet a
float64 logsumexp of the same scores within the forward table's tolerance
4e-3 + 3e-6 * |f|; the edge cases (nothing above GATE, empty pairs, one
live entry, spreads beyond expf's range, the widest band) and the bits of
a second run are checked too.  The card's tests (tests/test_torch_cuda.py)
hold the kernel itself against PR 10's design and the plain version."""

import os

import numpy as np
import pytest

from augustus_tpu_torch.engine import scan as S
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, piece_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
DATA = os.path.join(ROOT, "tests", "data")
NEG = np.float32(S.NEG)
ABS_TOL, REL_TOL = 4e-3, 3e-6
WIDEST = 36_575          # the most band entries of one position (6 kb piece)


def lse64(x):
    """The float64 logsumexp over the live (> GATE) entries, or NEG."""
    x = np.asarray(x, np.float64)
    live = x[x > S.GATE]
    if not live.size:
        return float(NEG)
    m = live.max()
    return float(m + np.log(np.exp(live - m).sum()))


def close(got, want):
    if want <= S.GATE:
        return got == NEG
    return abs(float(got) - want) <= ABS_TOL + REL_TOL * abs(want)


def scores(rng, n, dead=0.3, spread=40.0, base=None):
    """n float32 scores around a base of a forward table's size, a share
    of them NEG (entries that fail a gate)."""
    b = rng.uniform(-30_000.0, -100.0) if base is None else base
    x = (b - np.abs(rng.normal(0.0, spread, n))).astype(np.float32)
    x[rng.random(n) < dead] = NEG
    return x


@pytest.fixture(scope="module")
def band():
    """(static, int table, counts per position) of the 6 kb UTR piece."""
    args = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
            "UTR": "on", "softmasking": "0"}
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, _, _ = piece_scan(Model.load(args), rec, 6000, "cpu")
    itab = t["int_table"].numpy()
    tot = np.array([sum(S.segment_counts(st, itab[j], j)[0])
                    for j in range(st.n)])
    return st, itab, tot


def segment_pairs(st, irow, j, rng):
    """Each segment's scores and the pairs of its pieces at position j, as
    phase A makes them: the warps' shares (k2_shares), a piece's entry on
    lane (entry - chunk start) % 32, chunks of MAXP segments from the
    share's first segment."""
    cnt, _ = S.segment_counts(st, irow, j)
    off = np.concatenate([[0], np.cumsum(cnt)])
    T = int(off[-1])
    x = [scores(rng, c) for c in cnt]
    pieces = [[] for _ in cnt]
    for w, share in enumerate(S.k2_shares(st, irow, j)):
        s0 = T * w // S.K2_WARPS
        if not share:
            continue
        qa = share[0][0]
        for q, w_first, w_last in share:
            k = (q - qa) // S.MAXP
            e0 = s0 if k == 0 else int(off[qa + S.MAXP * k])
            i0 = max(s0, int(off[q]))
            a = i0 - int(off[q])
            pieces[q].append(S.share_piece_ref(
                x[q][a: a + w_last - w_first + 1], (i0 - e0) % 32))
    return x, pieces


def segment_value(pieces):
    """A segment's value as phase B takes it: one piece's pair, or the
    pieces merged by seg_value."""
    if not pieces:
        return NEG
    if len(pieces) == 1:
        return S.lse_value_ref(*pieces[0])
    return S.seg_value_ref([p[0] for p in pieces], [p[1] for p in pieces])


def test_band_positions_meet_float64(band):
    """At the widest position and 24 others of the 6 kb piece, every
    segment's value from its warps' pieces, and every conv state's value
    from its variants (+ H), within the tolerance of a float64 logsumexp
    of the same scores."""
    st, itab, tot = band
    rng = np.random.default_rng(11)
    live = np.flatnonzero(tot > 0)
    js = [int(np.argmax(tot))] + sorted(rng.choice(live, 24, replace=False))
    assert tot[js[0]] == WIDEST
    segs = S.segments(st)
    checked = 0
    for j in js:
        x, pieces = segment_pairs(st, itab[j], j, rng)
        vals = {}
        for q, (ci, vi) in enumerate(segs):
            got, want = segment_value(pieces[q]), lse64(x[q])
            assert close(got, want), (j, q, got, want)
            checked += len(x[q])
            if vi >= 0:
                H = np.float32(rng.normal(-3.0, 1.0))
                v = np.float32(got + H) if got > S.GATE else NEG
                vals.setdefault(ci, []).append((v, want + float(H)
                                                if want > S.GATE else NEG))
        for ci, vv in vals.items():
            got = S.fold_variants_ref([v for v, _ in vv])
            assert close(got, lse64([w for _, w in vv])), (j, ci)
    assert checked == sum(int(tot[j]) for j in js)


@pytest.mark.parametrize("n", [1, 3, 4, 11, 109])
def test_lane_run_meets_float64(n):
    """A lane's run of n entries in batches of BATCH (the last one padded
    with NEG), the maximum rising and falling across batches."""
    rng = np.random.default_rng(n)
    for _ in range(50):
        x = scores(rng, n, dead=0.2, spread=rng.choice([1.0, 30.0, 300.0]))
        assert close(S.lse_value_ref(*S.run_pair_ref(x)), lse64(x))


def test_phase_c_reduce_meets_float64():
    """reduce_c over 71 states (padded to 80 with -inf), some NEG."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        x = scores(rng, 71, dead=rng.choice([0.0, 0.5, 0.95]))
        assert close(S.reduce_c_ref(x), lse64(x))


def test_nothing_above_gate_is_neg():
    """Scores at or below GATE give the empty pair and NEG everywhere."""
    x = np.full(100, NEG, np.float32)
    x[::7] = np.float32(S.GATE)
    m, s = S.run_pair_ref(x)
    assert m == -np.inf and s == 0.0
    pm, ps = S.share_piece_ref(x)
    assert pm == -np.inf and ps == 0.0
    assert S.lse_value_ref(pm, ps) == NEG
    assert S.seg_value_ref([pm, pm], [ps, ps]) == NEG
    assert S.fold_variants_ref(x[:9]) == NEG
    assert S.fold_variants_ref([]) == NEG
    assert S.reduce_c_ref(x[:71]) == NEG


def test_empty_pairs_add_nothing():
    """Empty pairs (-inf, 0) among live ones: 31 empty lanes and one live
    lane give that lane's pair bit for bit; empty pieces of a cut segment
    leave the others' value."""
    rng = np.random.default_rng(2)
    x = scores(rng, 40, dead=0.0)
    m, s = S.run_pair_ref(x)
    for lane in (0, 13, 31):
        pm = np.full(32, -np.inf, np.float32)
        ps = np.zeros(32, np.float32)
        pm[lane], ps[lane] = m, s
        assert S.merge_parked_ref(pm, ps) == (m, s)
    got = S.seg_value_ref([-np.inf, m, -np.inf], [0.0, s, 0.0])
    assert got == S.lse_value_ref(m, s)


def test_one_live_entry_is_exact():
    """One live entry among NEG ones comes out as itself, bit for bit, in
    every shape."""
    rng = np.random.default_rng(3)
    for where in (0, 5, 63, 99):
        x = np.full(100, NEG, np.float32)
        x[where] = np.float32(rng.uniform(-20_000.0, -10.0))
        assert S.lse_value_ref(*S.share_piece_ref(x, where % 32)) == \
            x[where]
        assert S.reduce_c_ref(x[:71] if where < 71 else x[29:]) == x[where]
        assert S.fold_variants_ref(x[where - where % 9: where - where % 9
                                     + 9]) == x[where]


def test_spread_beyond_expf_range():
    """Entries more than 88 below the maximum (expf underflows to 0 or a
    subnormal): the value stays within the tolerance of float64, and the
    maximum's own term is never lost."""
    rng = np.random.default_rng(4)
    for spread in (90.0, 200.0, 5_000.0):
        x = scores(rng, 500, dead=0.1, spread=spread)
        pm, ps = S.share_piece_ref(x, 7)
        assert ps >= 1.0
        assert close(S.lse_value_ref(pm, ps), lse64(x))
        assert close(S.reduce_c_ref(x[:71]), lse64(x[:71]))


def test_widest_band_in_sixteen_shares():
    """A 36,575-entry band (the most of one position on the 6 kb piece)
    cut into the 16 warps' shares, merged as a cut segment."""
    rng = np.random.default_rng(6)
    x = scores(rng, WIDEST, dead=0.3, spread=60.0)
    pieces = []
    for w in range(S.K2_WARPS):
        s0, s1 = WIDEST * w // S.K2_WARPS, WIDEST * (w + 1) // S.K2_WARPS
        pieces.append(S.share_piece_ref(x[s0:s1]))
    assert close(segment_value(pieces), lse64(x))


def test_same_inputs_same_bits(band):
    """The shapes fix the order of every sum: a second run on the same
    inputs gives the same bits."""
    st, itab, tot = band
    j = int(np.argmax(tot))
    first = segment_pairs(st, itab[j], j, np.random.default_rng(9))[1]
    again = segment_pairs(st, itab[j], j, np.random.default_rng(9))[1]
    a = np.array([segment_value(p) for p in first], np.float32)
    b = np.array([segment_value(p) for p in again], np.float32)
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
