"""Array helpers for the host track builder (numpy, float64).

Host copy of `augustus_tpu/engine/xputil.py` in its numpy mode: the track
builder (engine/gold.py prepare + engine/device.py build_tracks +
engine/scan.py split_tracks + engine/pack.py pack_tracks) computes per-base
tables in float64 and rounds once to float32.  `DD` keeps the interface of
the reference's double-float pair; on the host it simply wraps float64
(lo is identically zero), so every op is plain float64 arithmetic.
"""

from __future__ import annotations

import numpy as np

F32_NEG = np.float32(-1.0e30)


def asarr(x, dtype=None):
    return np.asarray(x, dtype=dtype)


def shift_clip(track, c: int):
    """out[..., i] = track[..., clip(i + c, 0, L-1)] for a static integer
    shift (slice + edge pad).  Works for arrays and DD."""
    if isinstance(track, DD):
        return DD(shift_clip(track.hi, c), shift_clip(track.lo, c))
    L = track.shape[-1]
    if c == 0:
        return track
    if c > 0:
        c = min(c, L - 1)
        body = track[..., c:]
        edge = np.repeat(track[..., -1:], c, axis=-1)
        return np.concatenate([body, edge], axis=-1)
    c = min(-c, L - 1)
    body = track[..., : L - c]
    edge = np.repeat(track[..., :1], c, axis=-1)
    return np.concatenate([edge, body], axis=-1)


def sg(track, c: int, out_len=None):
    """shift_clip + optional truncation of the last axis."""
    out = shift_clip(track, c)
    if out_len is not None:
        out = out[..., :out_len]
    return out


def class_pick(arr, cls):
    """out[..., i] = arr[cls[i], ..., i]: a where-chain over the (small)
    leading class axis."""
    if isinstance(arr, DD):
        return DD(class_pick(arr.hi, cls), class_pick(arr.lo, cls))
    C = arr.shape[0]
    out = arr[0]
    for c in range(1, C):
        out = np.where(cls == c, arr[c], out)
    return out


def arange(n, dtype=None):
    return np.arange(n, dtype=dtype)


def ftype():
    """Float dtype for plain (non-DD) track math."""
    return np.float64


def sanitize(x):
    """nan/-inf/+inf -> F32_NEG, clamp below at F32_NEG."""
    y = np.asarray(x, dtype=ftype())
    y = np.where(np.isfinite(y), y, np.float64(F32_NEG))
    return np.maximum(y, np.float64(F32_NEG))


def _two_sum(a, b):
    with np.errstate(invalid="ignore"):
        s = a + b
        bb = s - a
        err = (a - (s - bb)) + (b - bb)
        err = np.where(np.isfinite(s), err, 0.0)
    return s, err


class DD:
    """Double-float value hi + lo.  On the host lo is identically zero and
    the ops reduce to float64 arithmetic bit for bit."""

    __slots__ = ("hi", "lo")
    # numpy must defer binary ops to DD's reflected methods (an ndarray
    # would otherwise treat DD as an opaque scalar -> object arrays)
    __array_priority__ = 1000
    __array_ufunc__ = None

    def __init__(self, hi, lo=None):
        self.hi = np.asarray(hi, dtype=ftype())
        self.lo = np.zeros_like(self.hi) if lo is None else lo

    @staticmethod
    def cumsum_dd(x, axis=-1):
        """Cumulative sum along `axis` of a plain array."""
        return DD(np.cumsum(np.asarray(x, dtype=ftype()), axis=axis))

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])

    def take(self, idx, axis=-1):
        return DD(np.take(self.hi, idx, axis=axis),
                  np.take(self.lo, idx, axis=axis))

    def _coerce(self, other):
        if isinstance(other, DD):
            return other
        return DD(np.asarray(other, dtype=ftype()))

    def __add__(self, other):
        o = self._coerce(other)
        s, e = _two_sum(self.hi, o.hi)
        lo = self.lo + o.lo + e
        hi, lo = _two_sum(s, lo)
        return DD(hi, lo)

    __radd__ = __add__

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return (-self) + self._coerce(other)

    def where(self, cond, other):
        """DD(where(cond, self, other))."""
        o = self._coerce(other)
        return DD(np.where(cond, self.hi, o.hi), np.where(cond, self.lo, o.lo))

    def value(self):
        """Collapse to a plain float64 array."""
        return self.hi + self.lo


class LinRamp:
    """coef * i for i in [-pad, n + pad), index-shifted by pad."""

    def __init__(self, coef: float, n: int, pad: int = 128):
        self.pad = pad
        self.ramp = DD(np.arange(-pad, n + pad, dtype=np.float64)
                       * float(coef))

    def at(self, idx):
        """DD of coef*idx; idx must lie in [-pad, n+pad)."""
        return self.ramp.take(np.clip(idx + self.pad, 0,
                                      self.ramp.shape[0] - 1))


def is_dd(x) -> bool:
    return isinstance(x, DD)


def val(x):
    """Plain float array from DD or array."""
    return x.value() if isinstance(x, DD) else x


def stk(parts, axis=0):
    """stack() that accepts DD or plain elements (uniform kinds)."""
    if parts and isinstance(parts[0], DD):
        return DD(np.stack([p.hi for p in parts], axis=axis),
                  np.stack([p.lo for p in parts], axis=axis))
    return np.stack(parts, axis=axis)


def where(cond, a, b):
    """where() accepting DD in either branch (result DD if any DD)."""
    if isinstance(a, DD) or isinstance(b, DD):
        ad = a if isinstance(a, DD) else DD(np.asarray(a, dtype=ftype()))
        return ad.where(cond, b)
    return np.where(cond, a, b)
