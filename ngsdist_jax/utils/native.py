"""ctypes loader for the ngsdist_jax native runtime library.

The native library (ngsdist_jax/native/src/ngsdist_native.c) carries the
host-side runtime: exact gz/TSV/binary readers, glibc-backed elementwise
transforms, the bootstrap index stream, and the bit-exact CPU pairwise
engine used as the md5-parity oracle.  It is built on demand with `make`
the first time it is requested.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libngsdist_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_c_dp = ctypes.POINTER(ctypes.c_double)
_c_fp = ctypes.POINTER(ctypes.c_float)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)


def _build() -> None:
    subprocess.run(
        ["make", "-s", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
        text=True,
    )


def _configure(lib: ctypes.CDLL) -> None:
    lib.nd_boot_block_indices.argtypes = [ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64, _c_u64p]
    lib.nd_boot_block_indices.restype = None
    lib.nd_taus_uniforms.argtypes = [ctypes.c_uint32, ctypes.c_uint64, _c_dp]
    lib.nd_taus_uniforms.restype = None
    lib.nd_exp_array.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_exp_array.restype = None
    lib.nd_log_array.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_log_array.restype = None
    lib.nd_fill_array.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_double]
    lib.nd_fill_array.restype = None
    lib.nd_postprob3.argtypes = [_c_dp, ctypes.c_int64]
    lib.nd_postprob3.restype = None
    lib.nd_call_geno3.argtypes = [_c_dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    lib.nd_call_geno3.restype = ctypes.c_int
    lib.nd_read_geno.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, _c_dp, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno.restype = ctypes.c_int
    lib.nd_spill_text_geno.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_spill_text_geno.restype = ctypes.c_int
    lib.nd_read_geno_pack23.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _c_fp, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_pack23.restype = ctypes.c_int
    lib.nd_read_geno_pack16.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_pack16.restype = ctypes.c_int
    lib.nd_read_geno_codes.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.nd_read_geno_codes.restype = ctypes.c_int
    lib.nd_format_matrix10f.argtypes = [
        _c_dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, _c_i64p,
    ]
    lib.nd_format_matrix10f.restype = ctypes.c_int
    lib.nd_pair_dists.argtypes = [
        _c_dp, ctypes.c_int64, ctypes.c_int64, _c_i64p, ctypes.c_int64,
        _c_dp, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, _c_dp, _c_dp, _c_dp,
    ]
    lib.nd_pair_dists.restype = ctypes.c_int
    lib.nd_em2_site_run.argtypes = [_c_dp, _c_dp, _c_dp]
    lib.nd_em2_site_run.restype = None


def get_lib() -> ctypes.CDLL:
    """Return the loaded native library, building it if necessary."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                _build()  # no-op when up to date; rebuilds stale .so
            except Exception:
                if not os.path.exists(_LIB_PATH):
                    raise
            lib = ctypes.CDLL(_LIB_PATH)
            _configure(lib)
            _lib = lib
    return _lib


def have_native() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def as_double_ptr(a: np.ndarray):
    assert a.dtype == np.float64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_dp)


def as_float_ptr(a: np.ndarray):
    assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_fp)


def as_uint8_ptr(a: np.ndarray):
    assert a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def as_uint16_ptr(a: np.ndarray):
    assert a.dtype == np.uint16 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def as_i64_ptr(a: np.ndarray):
    assert a.dtype == np.int64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_i64p)


def as_u64_ptr(a: np.ndarray):
    assert a.dtype == np.uint64 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(_c_u64p)
