"""Array helpers for the track builder, on numpy or on torch tensors.

Counterpart of `augustus_tpu/engine/xputil.py`.  The track builder
(engine/gold.py `_prepare_tracks` + engine/device.py `build_tracks` +
engine/scan.py `split_tracks` + engine/pack.py `pack_tracks`) is written
once against `A.xp`: numpy by default (the host route), or, inside
`use_torch(device)`, a small numpy-named namespace over torch tensors on
`device` (the device route, engine/device_prep.py).  Both compute the
per-base tables in float64 and round once to float32, so the two routes
give the same tables: the TPU's double-float32 pairs are not needed on a
card with float64.  `DD` keeps the interface of the reference's
double-float pair and wraps float64 (lo is identically zero);
`DD.cumsum_dd` is the ordered prefix sum, which on CUDA tensors runs the
`prefix_sum_f64` kernel (csrc/prefix.cu) so that it adds left to right as
numpy does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import stats

F32_NEG = np.float32(-1.0e30)


class _Accessor:
    """`A.xp` resolves to numpy (default) or the torch namespace of the
    innermost `use_torch`.  Not thread-safe; prep runs on one thread."""

    def __init__(self):
        self._xp = np

    @property
    def xp(self):
        return self._xp

    @property
    def is_torch(self) -> bool:
        return self._xp is not np


A = _Accessor()


class use_torch:
    """Run the track builders on torch tensors on `device`.  Inside, the
    default float type is float64, so that torch promotes Python floats
    with integer tensors as numpy does.  `prefix_sum` (prefix_sum_f64 when
    None) is the function DD.cumsum_dd calls, for a caller that records or
    replaces the prefix sums."""

    def __init__(self, device, prefix_sum=None):
        self.xp = TorchXP(device, prefix_sum)

    def __enter__(self):
        import torch
        self._prev = A._xp
        self._prev_dtype = torch.get_default_dtype()
        A._xp = self.xp
        torch.set_default_dtype(torch.float64)
        return self

    def __exit__(self, *exc):
        import torch
        A._xp = self._prev
        torch.set_default_dtype(self._prev_dtype)
        return False


def tdtype(dt):
    """The torch dtype of a numpy (or torch) dtype."""
    import torch
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32,
            np.dtype(np.int64): torch.int64,
            np.dtype(np.int32): torch.int32,
            np.dtype(np.int8): torch.int8,
            np.dtype(np.uint8): torch.uint8,
            np.dtype(bool): torch.bool}[np.dtype(dt)]


class TorchXP:
    """The numpy functions the track builders call, on torch tensors on one
    device.  numpy arrays (model tables) are copied to the device; numpy
    scalars become Python scalars, which torch types weakly as numpy 2
    does."""

    def __init__(self, device, prefix_sum=None):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.prefix_sum = prefix_sum or prefix_sum_f64

    # ---- conversion --------------------------------------------------
    def _t(self, x):
        torch = self.torch
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=self.device)
        if isinstance(x, np.generic):
            return x.item()
        return x

    def _upload(self, x, dtype=None):
        """Python data (a number, a list) as a tensor on the device.  torch
        copies it from the host below the dispatcher, where
        stats.dispatch_counts does not see the copy, so it is counted
        here."""
        t = self.torch.as_tensor(x, dtype=dtype, device=self.device)
        stats.upload(t)
        return t

    def _pair(self, a, b):
        """Both operands as tensors of their numpy result type."""
        torch = self.torch
        a, b = self._t(a), self._t(b)
        if not isinstance(a, torch.Tensor):
            a = self._upload(a, torch.result_type(b, a))
        if not isinstance(b, torch.Tensor):
            b = self._upload(b, torch.result_type(a, b))
        return a, b

    def asarray(self, x, dtype=None):
        torch = self.torch
        x = self._t(x)
        if not isinstance(x, torch.Tensor):
            x = self._upload(x)
        return x if dtype is None else x.to(tdtype(dtype))

    # ---- construction ------------------------------------------------
    def arange(self, *args, dtype=None):
        return self.torch.arange(*args, dtype=tdtype(dtype) or
                                 self.torch.int64, device=self.device)

    def zeros(self, shape, dtype=None):
        return self.torch.zeros(shape, dtype=tdtype(dtype) or
                                self.torch.float64, device=self.device)

    def full(self, shape, fill, dtype=None):
        return self.torch.full(shape if isinstance(shape, tuple) else
                               (shape,), self._t(fill), dtype=tdtype(dtype),
                               device=self.device)

    def zeros_like(self, x):
        return self.torch.zeros_like(x)

    # ---- shape -------------------------------------------------------
    def concatenate(self, parts, axis=0):
        return self.torch.cat([self.asarray(p) for p in parts], dim=axis)

    def stack(self, parts, axis=0):
        parts = [self.asarray(p) for p in parts]
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = self.torch.promote_types(dt, p.dtype)
        return self.torch.stack([p.to(dt) for p in parts], dim=axis)

    def broadcast_to(self, x, shape):
        return self.torch.broadcast_to(self.asarray(x), shape)

    def repeat(self, x, reps, axis=None):
        return self.torch.repeat_interleave(x, reps, dim=axis)

    def roll(self, x, shift):
        return self.torch.roll(x, shift)

    def take(self, x, idx, axis=-1):
        if axis not in (-1, x.dim() - 1):
            raise NotImplementedError("take along the last axis only")
        return x[..., idx]

    # ---- elementwise ---------------------------------------------------
    def where(self, cond, a, b):
        torch = self.torch
        a, b = self._t(a), self._t(b)
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = self._upload(a)
        return torch.where(self.asarray(cond), a, b)

    def clip(self, x, lo, hi):
        return self.torch.clamp(self.asarray(x), min=self._t(lo),
                                max=self._t(hi))

    def maximum(self, a, b):
        return self.torch.maximum(*self._pair(a, b))

    def minimum(self, a, b):
        return self.torch.minimum(*self._pair(a, b))

    def exp(self, x):
        return self.torch.exp(x)

    def isfinite(self, x):
        return self.torch.isfinite(x)

    def any(self, x, axis=None):
        return self.torch.any(x) if axis is None else \
            self.torch.any(x, dim=axis)

    def searchsorted(self, a, v, side="left"):
        return self.torch.searchsorted(self.asarray(a), self.asarray(v),
                                       right=(side == "right"))


def astype(x, dtype):
    """x.astype(dtype) for numpy arrays and torch tensors alike."""
    if isinstance(x, np.ndarray):
        return x.astype(dtype)
    return x.to(tdtype(dtype))


def host(x) -> np.ndarray:
    """x as a numpy array (one device-to-host copy for a tensor)."""
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


def asarr(x, dtype=None):
    return A.xp.asarray(x, dtype=dtype)


def shift_clip(track, c: int):
    """out[..., i] = track[..., clip(i + c, 0, L-1)] for a static integer
    shift (slice + edge pad).  Works for arrays and DD."""
    if isinstance(track, DD):
        return DD(shift_clip(track.hi, c), shift_clip(track.lo, c))
    xp = A.xp
    L = track.shape[-1]
    if c == 0:
        return track
    if c > 0:
        c = min(c, L - 1)
        body = track[..., c:]
        edge = xp.repeat(track[..., -1:], c, axis=-1)
        return xp.concatenate([body, edge], axis=-1)
    c = min(-c, L - 1)
    body = track[..., : L - c]
    edge = xp.repeat(track[..., :1], c, axis=-1)
    return xp.concatenate([edge, body], axis=-1)


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
    xp = A.xp
    C = arr.shape[0]
    out = arr[0]
    for c in range(1, C):
        out = xp.where(cls == c, arr[c], out)
    return out


def arange(n, dtype=None):
    return A.xp.arange(n, dtype=dtype)


def ftype():
    """Float dtype for plain (non-DD) track math: float64 on both
    backends."""
    return np.float64


def sanitize(x):
    """nan/-inf/+inf -> F32_NEG, clamp below at F32_NEG."""
    xp = A.xp
    y = xp.asarray(x, dtype=ftype())
    y = xp.where(xp.isfinite(y), y, np.float64(F32_NEG))
    return xp.maximum(y, np.float64(F32_NEG))


def seta(a, idx, vals):
    """A copy of the tensor a with a[idx] = vals, indices outside [0,
    len(a)) dropped (JAX's `.at[idx].set(vals, mode="drop")`).  idx holds
    no duplicate among the kept indices, so the result does not depend on
    the order of writes.  Device route only (tensors)."""
    xp = A.xp
    idx, vals = xp.asarray(idx), xp.asarray(vals)
    keep = (idx >= 0) & (idx < a.shape[0])
    out = a.clone()
    out[idx[keep]] = (vals[keep] if vals.dim() else vals).to(a.dtype)
    return out


def _two_sum(a, b):
    xp = A.xp
    if xp is np:
        with np.errstate(invalid="ignore"):
            s = a + b
            bb = s - a
            err = (a - (s - bb)) + (b - bb)
            err = np.where(np.isfinite(s), err, 0.0)
        return s, err
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    err = xp.where(xp.isfinite(s), err, xp.zeros_like(err))
    return s, err


# --------------------------------------------------------------------------
# the ordered float64 prefix sum: CUDA kernel and plain version
# --------------------------------------------------------------------------

def prefix_sum_f64_reference(x):
    """np.cumsum along the last axis of a float64 tensor: torch.cumsum on
    the CPU adds left to right, as numpy does, but from +0.0, so a row's
    leading run of -0.0 (which np.cumsum keeps) is set back to -0.0."""
    import torch
    out = torch.cumsum(x, dim=-1)
    if not x.numel() or not bool(torch.signbit(x[..., 0]).any()):
        return out
    neg_zero = (x == 0) & torch.signbit(x)
    lead = torch.cummin(neg_zero.to(torch.int8), dim=-1).values.bool()
    return torch.where(lead, torch.full_like(out, -0.0), out)


def prefix_sum_f64(x):
    """Inclusive prefix sum along the last axis of a float64 tensor, added
    strictly left to right (equal to np.cumsum bit for bit).

    Replaces `augustus_tpu/engine/xputil.py:DD.cumsum_dd`, whose
    compensated `lax.associative_scan` kept double-float32 pairs on the
    TPU.  CPU tensors run the plain version; CUDA tensors launch
    csrc/prefix.cu (and raise if it does not build or launch).
    `prefix_sum_f64.launches` counts kernel launches."""
    import torch
    if x.dtype != torch.float64:
        raise ValueError(f"prefix_sum_f64 takes float64, got {x.dtype}")
    if x.device.type == "cpu":
        return prefix_sum_f64_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from ._build import load
    lib = load("prefix")
    fn = lib.prefix_sum_f64_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    xc = x.contiguous()
    out = torch.empty_like(xc)
    L = xc.shape[-1] if xc.dim() else 1
    rows = xc.numel() // L if L else 0
    if rows and L:
        err = fn(xc.data_ptr(), out.data_ptr(), rows, L,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"prefix_sum_f64 kernel launch failed: CUDA "
                               f"error {err}")
        prefix_sum_f64.launches += 1
    return out


prefix_sum_f64.launches = 0


class DD:
    """Double-float value hi + lo.  Both backends compute in float64 and lo
    is identically zero, so every op is plain float64 arithmetic."""

    __slots__ = ("hi", "lo")
    # numpy must defer binary ops to DD's reflected methods (an ndarray
    # would otherwise treat DD as an opaque scalar -> object arrays)
    __array_priority__ = 1000
    __array_ufunc__ = None

    def __init__(self, hi, lo=None):
        xp = A.xp
        self.hi = xp.asarray(hi, dtype=ftype())
        self.lo = xp.zeros_like(self.hi) if lo is None else lo

    @staticmethod
    def cumsum_dd(x, axis=-1):
        """Cumulative sum along the last axis of a plain array, added left
        to right."""
        xp = A.xp
        if axis != -1:
            raise NotImplementedError("cumsum along the last axis only")
        if xp is np:
            return DD(np.cumsum(np.asarray(x, dtype=ftype()), axis=-1))
        return DD(xp.prefix_sum(xp.asarray(x, dtype=ftype())))

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])

    def take(self, idx, axis=-1):
        xp = A.xp
        return DD(xp.take(self.hi, idx, axis=axis),
                  xp.take(self.lo, idx, axis=axis))

    def _coerce(self, other):
        if isinstance(other, DD):
            return other
        return DD(A.xp.asarray(other, dtype=ftype()))

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
        xp = A.xp
        o = self._coerce(other)
        return DD(xp.where(cond, self.hi, o.hi), xp.where(cond, self.lo, o.lo))

    def value(self):
        """Collapse to a plain float64 array."""
        return self.hi + self.lo


def cumsum_rows(rows):
    """{key: prefix sum of rows[key] along its last axis}, added left to
    right, for a dict of 1-D and 2-D float64 arrays of one length: all rows
    in one DD.cumsum_dd call, so on the card one launch of the prefix-sum
    kernel runs every row at once."""
    xp = A.xp
    flat = [r if r.ndim == 2 else r[None] for r in rows.values()]
    cum = DD.cumsum_dd(xp.concatenate(flat, axis=0)).hi
    out, at = {}, 0
    for (key, r), f in zip(rows.items(), flat):
        out[key] = cum[at: at + f.shape[0]] if r.ndim == 2 else cum[at]
        at += f.shape[0]
    return out


class LinRamp:
    """coef * i for i in [-pad, n + pad), index-shifted by pad."""

    def __init__(self, coef: float, n: int, pad: int = 128):
        self.pad = pad
        xp = A.xp
        self.ramp = DD(xp.arange(-pad, n + pad, dtype=np.float64)
                       * float(coef))

    def at(self, idx):
        """DD of coef*idx; idx must lie in [-pad, n+pad)."""
        return self.ramp.take(A.xp.clip(idx + self.pad, 0,
                                        self.ramp.shape[0] - 1))


def is_dd(x) -> bool:
    return isinstance(x, DD)


def val(x):
    """Plain float array from DD or array."""
    return x.value() if isinstance(x, DD) else x


def stk(parts, axis=0):
    """stack() that accepts DD or plain elements (uniform kinds)."""
    xp = A.xp
    if parts and isinstance(parts[0], DD):
        return DD(xp.stack([p.hi for p in parts], axis=axis),
                  xp.stack([p.lo for p in parts], axis=axis))
    return xp.stack(parts, axis=axis)


def where(cond, a, b):
    """where() accepting DD in either branch (result DD if any DD)."""
    xp = A.xp
    if isinstance(a, DD) or isinstance(b, DD):
        ad = a if isinstance(a, DD) else DD(xp.asarray(a, dtype=ftype()))
        return ad.where(cond, b)
    return xp.where(cond, a, b)
