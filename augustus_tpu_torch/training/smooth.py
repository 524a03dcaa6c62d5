"""Kernel smoothing of empirical length distributions.

Bit-faithful equivalent of the reference Smooth class
(src/commontrain.cc:28-107): a normal kernel whose bandwidth grows linearly
with the length index (scaled by numevents^-0.2), widened until at least
``minwindowcount`` event positions fall in the half-window.  The accumulation
order of the C++ loops is preserved so the resulting float64 values are
bitwise identical.

Port of `augustus_tpu/training/smooth.py`: host numpy, no kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

SMOOTH_EPSILON = 1e-20
_FACTOR = 0.39894228   # 1/sqrt(2 pi)


def smooth_counts(counts: Sequence[int], minwindowcount: int,
                  slope_of_bandwidth: float, result_size: int = -1,
                  prior_size: int = 0) -> np.ndarray:
    """Smooth the count vector (reference Smooth::smoothCounts).

    ``prior_size``: size of the caller's pre-existing result vector; the
    reference enlarges resultSize to it (computeLengthDistributions passes
    vectors pre-assigned to max_exon_len+1).
    """
    counts = list(counts)
    n = len(counts)
    if result_size < 0:
        result_size = n
    if prior_size > result_size:
        result_size = prior_size
    result = np.zeros(result_size, dtype=np.float64)

    numevents = sum(counts)
    limit = result_size + 4 * slope_of_bandwidth * result_size
    for i in range(n):
        if i >= limit:
            break
        ci = counts[i]
        if ci <= 0:
            continue
        bandwidth = int(.01 + slope_of_bandwidth
                        * math.pow(float(numevents), -.2) * i)
        if bandwidth < 1:
            bandwidth = 1
        cumcountl = cumcountr = 0
        for j in range(i - bandwidth + 1, i + bandwidth):
            if 0 <= j < n:
                if j <= i and counts[j]:
                    cumcountl += 1
                if j >= i and counts[j]:
                    cumcountr += 1
        while cumcountl < minwindowcount and cumcountr < minwindowcount \
                and bandwidth < n:
            bandwidth += 1
            if i + bandwidth - 1 < n and counts[i + bandwidth - 1]:
                cumcountl += 1
            if i - bandwidth + 1 >= 0 and counts[i - bandwidth + 1]:
                cumcountr += 1
        if i < result_size:
            result[i] += _phi_normal(bandwidth, 0) * ci
        j = 1
        while i - j >= 0 or i + j < result_size:
            weight_j = _phi_normal(bandwidth, j) * ci
            if 0 <= i - j < result_size:
                result[i - j] += weight_j
            if 0 <= i + j < result_size:
                result[i + j] += weight_j
            if weight_j < SMOOTH_EPSILON:
                break
            j += 1
    return result


def _phi_normal(stderror: float, i: int) -> float:
    # expression order matches the reference phi_normal
    # (include/commontrain.hh:61): factor/h * exp(((-i/h)*i/h)/2)
    return _FACTOR / stderror * math.exp(- i / stderror * i / stderror / 2)


def scale_dbl_vector(v: np.ndarray, target: float = 1.0) -> np.ndarray:
    """Normalize in the reference's sequential order (scaleDblVector,
    src/commontrain.cc:13)."""
    kum = 0.0
    for x in v:
        kum += float(x)
    if kum != 0.0:
        factor = target / kum
        for i in range(v.shape[0]):
            v[i] = v[i] * factor
    return v
