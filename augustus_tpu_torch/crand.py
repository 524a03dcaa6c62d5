"""glibc rand() replica (TYPE_3 additive-feedback generator, seed 1).

A copy of `augustus_tpu/crand.py`: the sampling walk draws from it.

The reference samples alternative transcripts with the C library's unseeded
``rand()`` (src/vitmatrix.cc:300), whose stream is deterministic (equivalent
to ``srand(1)``).  Byte-exact posterior probabilities therefore require the
identical stream: r[i] = (r[i-31] + r[i-3]) mod 2^32, output r[i] >> 1,
initialized from the LCG 16807*x mod (2^31-1) and warmed up by 310 discards.
"""

from __future__ import annotations

RAND_MAX = 2147483647


class GlibcRand:
    def __init__(self, seed: int = 1):
        r = [0] * 34
        r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            # 16807 * r[i-1] % 2147483647 via Schrage's method on int32
            prev = r[i - 1]
            if prev >= 0x80000000:
                prev -= 0x100000000   # interpret as signed
            hi, lo = divmod(prev, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._buf = r
        self._idx = 34
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        buf = self._buf
        i = self._idx
        v = (buf[i - 31] + buf[i - 3]) & 0xFFFFFFFF
        buf.append(v)
        self._idx += 1
        if self._idx > 100000:      # keep the window bounded
            del buf[: self._idx - 34]
            self._idx = 34
        return v

    def rand(self) -> int:
        return self._next() >> 1

    def uniform(self) -> float:
        """(double) rand() / RAND_MAX as the reference computes it."""
        return self.rand() / RAND_MAX
