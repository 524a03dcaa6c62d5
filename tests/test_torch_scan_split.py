"""The band list of K2's kernel (csrc/scan.cu) on the CPU: how phase A cuts
each position's band entries into the 16 warps' shares, and why combining
the shares' last-maximum partials gives the whole band's result.

On the port's 6 kb UTR pieces of HS04636.fa, plain and softmasked with its
EST hints (built as tests/test_torch_scan.py builds them): the shares of
engine/scan.py:k2_shares, the kernel's share arithmetic, cover every
clipped entry of every gated convolution variant and every lessD entry
exactly once at every position; the pieces of a cut segment, parked in
the warps' FIRST and LAST slots as phase A parks them and combined as
phase B combines them, and (value, index) partials of any partition in
any order, equal `_last_max` over the whole band, bit for bit, ties,
-0.0, empty shares and all-NEG bands included.  The card's tests
(tests/test_torch_cuda.py) hold the kernel itself against its earlier
design and the plain version."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from augustus_tpu_torch.engine import scan as S
from augustus_tpu_torch.io.fasta import read_fasta
from augustus_tpu_torch.predict import Model, piece_scan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "augustus_tpu_torch", "data", "config")
HINTS = os.path.join(ROOT, "augustus_tpu_torch", "data", "hints")
DATA = os.path.join(ROOT, "tests", "data")
NEG = float(S.NEG)

PIECES = {"plain": ("HS04636.fa", None), "hinted": ("HS04636sm.fa",
                                                    "HS04636sm.E.gff")}


def _args(hints):
    a = {"species": "repo_fixture_utr", "AUGUSTUS_CONFIG_PATH": CONFIG,
         "UTR": "on", "softmasking": "0"}
    if hints:
        a.update(softmasking="1", hintsfile=os.path.join(HINTS, hints),
                 extrinsicCfgFile="extrinsic.M.RM.E.W.cfg")
    return a


@pytest.fixture(scope="module", params=sorted(PIECES))
def piece(request):
    fasta, hints = PIECES[request.param]
    rec = read_fasta(os.path.join(DATA, fasta))[0]
    st, t, _, _ = piece_scan(Model.load(_args(hints)), rec, 6000, "cpu")
    return request.param, st, t["int_table"].numpy()


def _clipped(st, irow, j):
    """Each segment's entries at position j, counted independently of
    engine/scan.py (as tests/test_torch_scan.py's _reads marks them): the
    begins of a gated variant inside [smin, smax], vb_lo / vb_hi and the
    band, as entry indices w; a lessD window's W entries."""
    out = []
    for cv in st.convs:
        on = int(irow[cv.gate_col]) & 1
        smin, smax = int(irow[cv.smin_col]), int(irow[cv.smax_col])
        for v in cv.variants:
            b0 = j + cv.a_off - v.len_hi
            lo, hi = max(smin, b0), min(smax, b0 + v.width - 1)
            if v.vb_lo is not None:
                lo = max(lo, v.vb_lo)
            if v.vb_hi is not None:
                hi = min(hi, v.vb_hi)
            out.append(range(lo - b0, hi - b0 + 1) if on else range(0))
    out.extend(range(d.window) for d in st.lessd)
    return out


def test_shares_cover_every_clipped_entry_once(piece):
    """At every position, the 16 shares walk each clipped entry of each
    gated variant and each lessD entry once, and nothing else; the shares
    differ in size by at most one entry."""
    name, st, itab = piece
    total = []
    for j in range(1, st.n):
        want = _clipped(st, itab[j], j)
        got = [[] for _ in want]
        sizes = []
        for share in S.k2_shares(st, itab[j], j):
            sizes.append(sum(hi - lo + 1 for _, lo, hi in share))
            for q, lo, hi in share:
                got[q].extend(range(lo, hi + 1))
        for q, r in enumerate(want):
            assert sorted(got[q]) == list(r), (name, j, q)
            assert len(set(got[q])) == len(got[q])
        assert max(sizes) - min(sizes) <= 1
        total.append(sum(sizes))
    # the widest positions of the UTR pieces run into tens of thousands
    assert max(total) > 30_000 and min(total) >= 6 * 59


def _partial(scores, idx):
    """A lane's or a share's last maximum over its entries in ascending
    order: (value, index), (-inf, -1) when it holds none."""
    v, i = np.float32(-np.inf), -1
    for s, w in zip(scores, idx):
        if s >= v:
            v, i = s, w
    return v, i


def _combine(parts):
    """The partials in ascending order, ties to the larger index (phase B's
    last_max_into)."""
    v, i = np.float32(-np.inf), -1
    for ov, oi in parts:
        if ov > v or (ov == v and oi > i):
            v, i = ov, oi
    return v, i


def _reference(scores):
    got = S._last_max(torch.from_numpy(np.asarray(scores, np.float32)))
    return np.float32(got[0]), got[1]


def _scores(rng, m):
    """Band scores with many ties: a few finite values, NEG, -0.0 and
    +0.0."""
    pool = np.array([NEG, -0.0, 0.0, -1.5, 2.25, 2.25, -7.0], np.float32)
    return pool[rng.integers(0, len(pool), m)]


def _same(a, b):
    return np.float32(a[0]).view(np.int32) == np.float32(b[0]).view(
        np.int32) and a[1] == b[1]


def test_piece_partials_combine_to_last_max(piece):
    """On the pieces' own shares (at the 40 positions with the most entries
    and 40 others), random tied scores for each segment: the shares'
    partials, each reduced over 32 lanes that take every 32nd entry,
    combined in ascending order, give _last_max of the whole band."""
    name, st, itab = piece
    rng = np.random.default_rng(9)
    tot = np.array([sum(S.segment_counts(st, itab[j], j)[0])
                    for j in range(1, st.n)])
    picks = np.concatenate([np.argsort(tot)[-40:],
                            rng.choice(len(tot), 40, replace=False)]) + 1
    checked = 0
    for j in picks:
        segs = {}
        for share in S.k2_shares(st, itab[j], int(j)):
            for q, lo, hi in share:
                segs.setdefault(q, []).append((lo, hi))
        for q, pieces in segs.items():
            lo0, hi0 = pieces[0][0], pieces[-1][1]
            sc = _scores(rng, hi0 - lo0 + 1)
            parts = []
            for lo, hi in pieces:
                lanes = [_partial(sc[w - lo0: hi - lo0 + 1: 32],
                                  range(w, hi + 1, 32))
                         for w in range(lo, min(lo + 32, hi + 1))]
                parts.append(_combine(lanes))
            ref = _reference(sc)
            assert _same(_combine(parts), (ref[0], ref[1] + lo0))
            checked += 1
    assert checked > 1000


def _phase_b(shares, cnt, parts):
    """csrc/scan.cu's bookkeeping of phase A and phase B: each warp's
    piece of a segment goes to the segment's result when the share holds
    it whole, else to the warp's FIRST slot (cut at its start) or LAST
    slot (cut at its end), and the segment's first and last warps are
    noted; an empty share leaves a neutral FIRST.  Phase B takes the
    whole result, or LAST of the first warp and FIRST of every later one
    up to the last.  parts[(w, q)]: the warp's partial of segment q."""
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(int)
    T = int(off[-1])
    first = {w: (np.float32(-np.inf), -1) for w in range(S.K2_WARPS)}
    last, res, wf, wl = {}, {}, {}, {}
    for w, share in enumerate(shares):
        s0, s1 = T * w // S.K2_WARPS, T * (w + 1) // S.K2_WARPS
        for q, _, _ in share:
            i0, i1 = max(s0, off[q]), min(s1, off[q + 1])
            if i0 > off[q]:
                first[w] = parts[(w, q)]
            elif i1 < off[q + 1]:
                last[w] = parts[(w, q)]
            else:
                res[q] = parts[(w, q)]
            if i0 == off[q]:
                wf[q] = w
            if i1 == off[q + 1]:
                wl[q] = w
    out = {}
    for q in range(len(cnt)):
        if cnt[q] == 0:
            continue
        if wf[q] == wl[q]:
            out[q] = res[q]
        else:
            out[q] = _combine([last[wf[q]]] + [first[w] for w in
                                               range(wf[q] + 1, wl[q] + 1)])
    return out


def test_cut_segments_combine_from_the_warps_slots(piece):
    """At every 7th position, random tied scores for every segment: the
    warps' pieces, parked whole or in FIRST / LAST slots as phase A parks
    them, combined as phase B combines them, give _last_max of each whole
    segment; a cut segment spans consecutive warps."""
    name, st, itab = piece
    rng = np.random.default_rng(11)
    cut = 0
    for j in range(1, st.n, 7):
        cnt, w0s = S.segment_counts(st, itab[j], j)
        shares = S.k2_shares(st, itab[j], j)
        scores = {q: _scores(rng, c) for q, c in enumerate(cnt) if c}
        parts, holders = {}, {}
        for w, share in enumerate(shares):
            for q, lo, hi in share:
                k0 = lo - w0s[q]
                parts[(w, q)] = _partial(scores[q][k0: hi - w0s[q] + 1],
                                         range(lo, hi + 1))
                holders.setdefault(q, []).append(w)
        for q, ws in holders.items():
            assert ws == list(range(ws[0], ws[-1] + 1))
            cut += len(ws) > 1
        for q, got in _phase_b(shares, cnt, parts).items():
            ref = _reference(scores[q])
            assert _same(got, (ref[0], ref[1] + w0s[q]))
    assert cut > 100


@pytest.mark.parametrize("kind", ["random", "empty_shares", "all_neg"])
def test_random_partitions_combine_to_last_max(kind):
    """Bands cut at random points into contiguous shares, some empty, the
    partials combined in ascending order and also in a shuffled order
    (the rule is commutative): equal to _last_max, bit for bit."""
    rng = np.random.default_rng({"random": 1, "empty_shares": 2,
                                 "all_neg": 3}[kind])
    empty = 0
    for _ in range(300):
        m = int(rng.integers(1, 400))
        sc = _scores(rng, m)
        if kind == "all_neg":
            sc[:] = NEG
        k = int(rng.integers(1, 17))
        if kind == "empty_shares":
            cuts = np.sort(rng.integers(0, m + 1, k - 1))
        else:
            cuts = np.sort(rng.choice(np.arange(1, m), min(k - 1, m - 1),
                                      replace=False))
        bounds = np.concatenate([[0], cuts, [m]]).astype(int)
        parts = [_partial(sc[a:b], range(a, b))
                 for a, b in zip(bounds[:-1], bounds[1:])]
        empty += sum(p[1] < 0 for p in parts)
        ref = _reference(sc)
        assert _same(_combine(parts), ref)
        order = rng.permutation(len(parts))
        assert _same(_combine([parts[i] for i in order]), ref)
        if kind == "all_neg":
            assert ref[0] == np.float32(NEG) and ref[1] == m - 1
    assert (empty > 0) == (kind == "empty_shares")


def test_parked_partials_in_a_skewed_order_give_the_last_max():
    """Phase A's last step: the 32 lanes' parked partials of one segment
    (a lane without entries there parks (-inf, -1)), reduced by one lane
    starting at its own lane number and wrapping around (lane k reads lane
    (l + k) mod 32 at step l, so that no two lanes read one bank), give
    _last_max over the segment's entries for every starting lane, ties,
    -0.0 and +0.0 included."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        m = int(rng.integers(1, 200))
        sc = _scores(rng, m)
        first = int(rng.integers(0, 32))      # the lane of entry 0
        parked = [_partial(sc[(l - first) % 32::32],
                           range((l - first) % 32, m, 32))
                  for l in range(32)]
        ref = _reference(sc)
        for k in (0, 5, 31, int(rng.integers(0, 32))):
            got = _combine(parked[(l + k) % 32] for l in range(32))
            assert _same(got, ref)


def test_descriptor_names_each_segment_once(piece):
    """The descriptor's segment table lists every variant of every
    convolution, then every lessD window, each record pointing at its
    first segment; the shared-memory layout fits the block."""
    name, st, _ = piece
    t = {f"lenvec{ei}_{vi}": np.zeros(v.width, np.float32)
         for ei, cv in enumerate(st.convs)
         for vi, v in enumerate(cv.variants)}
    t.update({d.lenvec_key: np.zeros(d.window, np.float32)
              for d in st.lessd})
    desc, _ = S._descriptor(st, t)
    nseg, off = desc[22], desc[23]
    assert nseg == len(S.segments(st)) == sum(
        len(cv.variants) for cv in st.convs) + len(st.lessd)
    seg = desc[off: off + S.SG_SIZE * nseg].reshape(-1, S.SG_SIZE)
    tasks = desc[desc[10]: desc[10] + desc[9]]
    recs = tasks & 0xFFFFFF
    q = 0
    for ci, cv in enumerate(st.convs):
        assert desc[recs[ci] + 11] == q          # CV_SEG
        for vi, v in enumerate(cv.variants):
            assert tuple(seg[q, :2]) == (recs[ci], vi)
            # gate column, begin offset, width, H column and offset base
            assert seg[q, 2] == cv.gate_col and seg[q, 8] == v.width
            assert seg[q, 5] == cv.a_off - v.len_hi and seg[q, 16] == v.h_col
            assert seg[q, 17] == v.len_hi - cv.a_off + cv.bpl + 1
            q += 1
    for li, d in enumerate(st.lessd):
        r = recs[len(st.convs) + li]
        assert desc[r + 10] == q                                 # LD_SEG
        assert tuple(seg[q, :3]) == (r, -1, -1) and seg[q, 8] == d.window
        q += 1
    lay = S.smem_layout(st, desc.size)
    assert list(desc[24:39]) == [lay[k] for k in S.SMEM_REGIONS[:3]] + \
        [lay["rw"]] + [lay[k] for k in S.SMEM_REGIONS[3:]] + [lay["words"]]
    assert lay["bytes"] <= S.SMEM_BYTES and lay["rw"] >= st.NSC + st.NIC


def test_too_many_segments_are_refused():
    """A piece with more than MAX_SEG band segments raises
    NotImplementedError on every device, before any launch."""
    rec = read_fasta(os.path.join(DATA, "HS04636.fa"))[0]
    st, t, v0, _ = piece_scan(Model.load(_args(None)), rec, 300, "cpu")
    cv = st.convs[0]
    many = dataclasses.replace(st, convs=st.convs + (dataclasses.replace(
        cv, variants=cv.variants * 300),))
    with pytest.raises(NotImplementedError, match="at most 256"):
        S.check_limits(many)
    before = S.scan_forward.launches
    with pytest.raises(NotImplementedError, match="at most 256"):
        S.scan_forward(many, t, v0)
    assert S.scan_forward.launches == before
