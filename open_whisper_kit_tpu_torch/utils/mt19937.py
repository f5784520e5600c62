# Source: open_whisper_kit_tpu/utils/mt19937.py, copied as it stands (pure Python and numpy, no JAX).
"""std::mt19937 + libstdc++ std::discrete_distribution, bit-faithful.

The reference's decoders each own an ``std::mt19937`` (seeded with the
decoder index: src/whisper.cpp:3470 for decoder 0 at state init,
src/whisper.cpp:6929 for decoders 1..n-1 at every whisper_full entry) and
draw beam candidates / sampled tokens from
``std::discrete_distribution<>(probs)`` (src/whisper.cpp:6504-6508,
6577-6580).  Reproducing those draws bit-for-bit needs three pieces,
all implemented here against libstdc++'s concrete algorithms:

1. the MT19937 engine itself (standard init_genrand seeding + tempering);
2. ``std::generate_canonical<double, 53, mt19937>`` — TWO engine draws
   combined as ``(x0 + x1*2**32) / 2**64`` in double arithmetic, clamped
   to ``nextafter(1, 0)`` if the rounded quotient reaches 1.0
   (libstdc++ bits/random.tcc, the ``_Adaptor<engine, double>`` used by
   every real-valued distribution);
3. ``discrete_distribution``'s parameter table: weights converted
   float->double, normalized by their *sequential* double sum, then
   ``partial_sum``-ed into a cumulative array whose last entry is forced
   to 1.0; ``operator()`` is a single canonical variate looked up with
   ``lower_bound`` (first cp[i] >= u).

numpy's ``cumsum`` (``np.add.accumulate``) is strictly sequential, so both
the ``std::accumulate`` total and the ``std::partial_sum`` table reproduce
libstdc++'s exact double rounding.  ``tests/test_mt19937_oracle.py``
builds a C++ harness against the in-image libstdc++ and diffs draw
sequences directly.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)

_TWO32 = 4294967296.0          # 2**32 as double (exact)
_TWO64 = 18446744073709551616.0  # 2**64 as double (exact)
_ONE_BELOW_1 = np.nextafter(1.0, 0.0)


class MT19937:
    """std::mt19937 with single-value seeding (init_genrand)."""

    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, np.uint32)
        mt[0] = np.uint32(seed)
        x = np.uint64(seed) & np.uint64(0xFFFFFFFF)
        for i in range(1, _N):
            # x[i] = 1812433253 * (x[i-1] ^ (x[i-1] >> 30)) + i  (mod 2^32)
            x = (np.uint64(1812433253) * (x ^ (x >> np.uint64(30)))
                 + np.uint64(i)) & np.uint64(0xFFFFFFFF)
            mt[i] = np.uint32(x)
        self._mt = mt
        self._buf = np.empty(0, np.uint32)
        self._pos = 0

    def _twist(self) -> None:
        # In-place sequential twist: mt[i] = mt[(i+M)%N] ^ f(y_i) where
        # indices (i+M)%N < i read values ALREADY UPDATED this round, and
        # y_623 reads the updated mt[0].  Chunk at the dependency lag
        # (N-M = 227) so each slice only consumes earlier slices' output.
        mt = self._mt.copy()

        def f(y):
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A,
                           np.uint32(0))
            return (y >> np.uint32(1)) ^ mag

        for lo, hi in ((0, _N - _M), (_N - _M, 2 * (_N - _M)),
                       (2 * (_N - _M), _N - 1)):
            y = (mt[lo:hi] & _UPPER) | (mt[lo + 1:hi + 1] & _LOWER)
            src = mt[lo + _M:hi + _M] if hi + _M <= _N \
                else mt[lo + _M - _N:hi + _M - _N]
            mt[lo:hi] = src ^ f(y)
        y_last = (mt[_N - 1] & _UPPER) | (mt[0] & _LOWER)
        mt[_N - 1] = mt[_M - 1] ^ f(np.uint32(y_last))
        self._mt = mt
        # temper the whole block at once
        z = self._mt.copy()
        z ^= z >> np.uint32(11)
        z ^= (z << np.uint32(7)) & np.uint32(0x9D2C5680)
        z ^= (z << np.uint32(15)) & np.uint32(0xEFC60000)
        z ^= z >> np.uint32(18)
        self._buf = z
        self._pos = 0

    def draw(self) -> int:
        """One 32-bit engine output (std::mt19937::operator())."""
        if self._pos >= self._buf.shape[0]:
            self._twist()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def draw_block(self, n: int) -> np.ndarray:
        """n consecutive 32-bit outputs as uint32 array."""
        out = np.empty(n, np.uint32)
        for i in range(n):
            out[i] = self.draw()
        return out

    def canonical(self) -> float:
        """std::generate_canonical<double, 53>: two draws -> [0, 1)."""
        x0 = float(self.draw())
        x1 = float(self.draw())
        u = (x0 + x1 * _TWO32) / _TWO64
        return _ONE_BELOW_1 if u >= 1.0 else u


class DiscreteDistribution:
    """libstdc++ std::discrete_distribution over float weights."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, np.float64)
        if w.size < 2:
            self._cp = None
            return
        cs = np.cumsum(w)
        total = cs[-1]                    # sequential std::accumulate
        cp = np.cumsum(w / total)         # sequential std::partial_sum
        cp[-1] = 1.0
        self._cp = cp

    def __call__(self, rng: MT19937) -> int:
        if self._cp is None:
            return 0
        u = rng.canonical()
        # lower_bound: first index with cp[i] >= u
        return int(np.searchsorted(self._cp, u, side="left"))

    def draw_k(self, rng: MT19937, k: int) -> list[int]:
        return [self(rng) for _ in range(k)]
