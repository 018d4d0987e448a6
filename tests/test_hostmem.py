"""Threaded host staging: parallel_astype / parallel_cast_pad and the
native threaded fill (nd_fill_array) must be value-identical to their
serial numpy equivalents — they exist to parallelize the first-touch
page faults of large fresh tensors (and the cast bandwidth), not to
change any arithmetic."""

import numpy as np

from ngsdist_jax.utils import native as nat
from ngsdist_jax.utils.hostmem import parallel_astype, parallel_cast_pad


def test_parallel_astype_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.random((5000, 700))  # 28 MB: over the parallel threshold
    y = parallel_astype(x, np.float32)
    np.testing.assert_array_equal(y, x.astype(np.float32))
    # same-dtype passthrough (no copy)
    assert parallel_astype(x, np.float64) is x
    # small arrays take the serial path
    s = rng.random((3, 4))
    np.testing.assert_array_equal(parallel_astype(s, np.float32),
                                  s.astype(np.float32))


def test_parallel_cast_pad_matches_pad():
    rng = np.random.default_rng(1)
    x = rng.random((5000, 700))
    z = parallel_cast_pad(x, np.float32, 5600)
    assert z.shape == (5600, 700) and z.dtype == np.float32
    np.testing.assert_array_equal(z[:5000], x.astype(np.float32))
    assert (z[5000:] == 0).all()
    # no-op case returns the input itself
    assert parallel_cast_pad(x, np.float64, 5000) is x
    # empty source pads to all-zero
    e = parallel_cast_pad(np.zeros((0, 3, 3)), np.float32, 7)
    assert e.shape == (7, 3, 3) and (e == 0).all()


def test_nd_fill_array():
    lib = nat.get_lib()
    a = np.empty(1 << 21)
    lib.nd_fill_array(nat.as_double_ptr(a), a.size, -1.0e15)
    assert (a == -1.0e15).all()
    b = np.empty(17)  # below the threading threshold
    lib.nd_fill_array(nat.as_double_ptr(b), b.size, 2.5)
    assert (b == 2.5).all()
