"""Pure-Python Tausworthe RNG matching the native taus.h implementation.

The bootstrap block-resampling stream of the reference is a single global
taus generator consuming one uniform per (replicate, destination block)
in row order (/root/reference/ngsDist.cpp:217-237,423 and
shared/gen_func.cpp:117-119).  This module reproduces that stream in
Python so bootstrap index tables can be built host-side without the
native library; `ngsdist_jax.utils.native` provides the C version and
tests assert the two agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF


class TausRng:
    """Combined three-component Tausworthe generator (L'Ecuyer 1996)."""

    def __init__(self, seed: int):
        s = seed & _M32
        if s == 0:
            s = 1
        s1 = (69069 * s) & _M32
        if s1 < 2:
            s1 += 2
        s2 = (69069 * s1) & _M32
        if s2 < 8:
            s2 += 8
        s3 = (69069 * s2) & _M32
        if s3 < 16:
            s3 += 16
        self.s1, self.s2, self.s3 = s1, s2, s3
        for _ in range(6):
            self.next_u32()

    def next_u32(self) -> int:
        s1, s2, s3 = self.s1, self.s2, self.s3
        s1 = (((s1 & 4294967294) << 12) & _M32) ^ ((((s1 << 13) & _M32) ^ s1) >> 19)
        s2 = (((s2 & 4294967288) << 4) & _M32) ^ ((((s2 << 2) & _M32) ^ s2) >> 25)
        s3 = (((s3 & 4294967280) << 17) & _M32) ^ ((((s3 << 3) & _M32) ^ s3) >> 11)
        self.s1, self.s2, self.s3 = s1, s2, s3
        return s1 ^ s2 ^ s3

    def uniform(self) -> float:
        """Uniform deviate on [0,1): 32 bits scaled by 2^-32."""
        return self.next_u32() / 4294967296.0


def boot_block_indices(seed: int, n_reps: int, n_blocks: int) -> np.ndarray:
    """Source-block index table [n_reps, n_blocks] for block bootstrap.

    Row r holds the source block drawn for each destination block of
    replicate r+1 (replicate 0 is the unresampled data and consumes no
    draws).  Matches rnd_map_data's floor(min + u*(max-min)) draw
    (/root/reference/ngsDist.cpp:423, gen_func.cpp:117-119).
    """
    rng = TausRng(seed)
    out = np.empty((n_reps, n_blocks), dtype=np.uint64)
    for r in range(n_reps):
        for b in range(n_blocks):
            out[r, b] = int(np.floor(rng.uniform() * n_blocks))
    return out
