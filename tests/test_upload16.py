"""uint16 fixed-point uploads (NGSDIST_UPLOAD16, hostmem.pack16).

2-component f32 uploads (pack23, 8 bytes/triple) halve again to uint16
fixed point (4 bytes/triple) on f32 engines: q = rint(p * 65534) with
65535 reserved as the row sentinel.  These tests pin the contract:

(a) the grid argument — one quantization step (1/65534 = 1.526e-5)
    exceeds EPSILON = 1e-5 and 3*q = 65534 has no integer solution, so
    NO quantized data triple can be classified missing on device;
    missingness is decided on the host at source precision and carried
    only by the sentinel, making valid/missing classification (and
    hence cnt under pairwise deletion) EXACTLY the f64 engine's;
(b) dequantization accuracy: components within a half-step (7.63e-6),
    one-hot triples exact (q/65534 division is exact at endpoints);
(c) sentinel semantics match PAD23: pad tails, host-missing triples
    and data-borne all-zero triples expand to the inert all-zero
    triple; literal-NaN rows expand to all-NaN and keep poisoning;
(d) distance-level deltas vs the f32 pack23 route stay ~1e-6 — below
    the f32 engine's own error vs f64 (quantization noise averages
    over the site axis inside raw/cnt);
(e) the mesh/SiteStream round staging inherits the lane (uint16
    buffers + PAD16 tails) with results matching the full upload.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ngsdist_jax.core import distance as dist
from ngsdist_jax.parallel import mesh as pm
from ngsdist_jax.parallel import multihost as mh
from ngsdist_jax.utils import hostmem

SCORE = np.array([[0, 0.5, 1], [0.5, 0, 0.5], [1, 0.5, 0]])


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(n_devices=8)


def _probs(S, N, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[::17] = 1.0 / 3.0           # exactly-uniform missing triples
    P[3::29, N // 2] = [0, 0, 1]  # one-hot
    P[7::31, N // 3] = [1, 0, 0]
    P[11::37, N // 4] = [0, 0, 0]  # data-borne all-zero (empty line)
    P[5::41] = 0.0
    return P


def _host_miss(P):
    d01 = np.abs(P[..., 0] - P[..., 1])
    d12 = np.abs(P[..., 1] - P[..., 2])
    return (d01 < 1e-5) & (d12 < 1e-5)


def test_pack16_sentinels_and_accuracy(monkeypatch):
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    P = _probs(600, 8)
    P[13, 2] = np.nan  # literal-nan row
    Q = hostmem.pack23(P, np.float32, n_rows=640)
    assert Q.dtype == np.uint16 and Q.shape == (640, 8, 2)
    # pad tail: all-zero sentinel; missing rows: quantized-mean sentinel
    assert (Q[600:, :, 0] == hostmem.PAD16).all()
    assert (Q[600:, :, 1] == 0).all()
    miss = _host_miss(P)
    assert (Q[:600][miss][:, 0] == hostmem.PAD16).all()
    mean_q = np.rint(P.sum(-1)[:600][miss] / 3.0 * hostmem.U16_ONE)
    np.testing.assert_array_equal(Q[:600][miss][:, 1], mean_q)
    assert (Q[13, 2] == [hostmem.PAD16, hostmem.PAD16]).all()
    # non-missing rows quantize within a half step
    ok = ~miss & ~np.isnan(P[..., 0])
    r = Q[:600].astype(np.float64) / hostmem.U16_ONE
    assert np.abs(r[ok] - P[ok][:, :2]).max() <= 0.5 / hostmem.U16_ONE + 1e-12


def test_expand_matches_sentinel_contract(monkeypatch):
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    P = _probs(600, 8, seed=3)
    P[21, 1] = np.nan
    P3 = np.asarray(dist.put_probs(P, jnp.float32))
    assert P3.dtype == np.float32
    miss = _host_miss(P)
    # sentinel rows -> value-preserving uniform triples (the reference
    # USES missing values in the non-pairwise-deletion unmasked sums);
    # device missing_mask flags exactly the host decision (grid
    # argument: no quantized data row can test missing)
    mm = miss & ~np.isnan(P[..., 0])
    means = P.sum(-1)[mm][:, None] / 3.0
    assert (P3[mm] == P3[mm][:, :1]).all()  # all-equal -> dev-missing
    assert np.abs(P3[mm] - means).max() <= 0.5 / hostmem.U16_ONE + 1e-7
    zero = mm & (P.sum(-1) == 0)
    assert (P3[zero] == 0).all()  # empty-line rows stay exactly inert
    dev_miss = np.asarray(dist.missing_mask(jnp.asarray(P3)))
    nan_rows = np.isnan(P[..., 0]) | np.isnan(P[..., 1]) | np.isnan(P[..., 2])
    np.testing.assert_array_equal(dev_miss, miss & ~nan_rows)
    assert np.isnan(P3[21, 1]).all()
    # one-hot triples reconstruct to within 1 ulp at the endpoints
    # (multiply dequantization; see the expand23 docstring for why the
    # exact-endpoint where() form is forbidden on the CPU backend)
    assert np.abs(P3[3::29, 4] - np.array([0, 0, 1], np.float32)).max() < 1e-9
    assert np.abs(P3[7::31, 2] - np.array([1, 0, 0], np.float32)).max() < 1e-9
    # everything else: p0/p1 within a half-step; p2 = 1 - r0 - r1
    # carries both components' errors (up to a full step)
    ok = ~miss & ~nan_rows
    err = np.abs(P3[ok] - P[ok])
    assert err[:, :2].max() <= 0.5 / hostmem.U16_ONE + 1e-7
    assert err[:, 2].max() <= 1.0 / hostmem.U16_ONE + 1e-7


def test_borderline_rows_cannot_flip(monkeypatch):
    """Rows engineered within one quantization step of the EPSILON
    boundary: the device classification must still equal the host f64
    decision (the 3q = 65534 impossibility), not drift with rounding."""
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    base = 0.3333
    deltas = np.linspace(-3e-5, 3e-5, 101)
    P = np.empty((101, 1, 3))
    for i, d in enumerate(deltas):
        p0 = base + d
        p1 = base
        P[i, 0] = [p0, p1, 1.0 - p0 - p1]
    host = _host_miss(P)
    P3 = np.asarray(dist.put_probs(P, jnp.float32))
    dev = np.asarray(dist.missing_mask(jnp.asarray(P3)))
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("pairwise_del", [True, False])
def test_suffstats_parity_vs_f32(monkeypatch, pairwise_del):
    """Both deletion modes: the non-pairwise mode is the one a zeroing
    sentinel silently broke (missing values feed the unmasked sum)."""
    P = _probs(4096, 12, seed=1)
    S = P.shape[0]
    score = jnp.asarray(SCORE, jnp.float32)
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("NGSDIST_UPLOAD16", mode)
        Pd = dist.put_probs(P, jnp.float32)
        raw, cnt = dist.indep_suffstats(Pd, score, pairwise_del)
        out[mode] = (np.asarray(raw),
                     None if cnt is None else np.asarray(cnt))
    if pairwise_del:
        # identical valid-pair counts (missing decisions are the same)
        np.testing.assert_array_equal(out["0"][1], out["1"][1])
        denom = np.maximum(out["0"][1], 1)
    else:
        denom = float(S)
    # raw deltas stay in the f32 engine's own error class
    d = np.abs(out["0"][0] - out["1"][0]) / denom
    assert d.max() < 3e-6, d.max()


def test_mesh_rounds_match_full_upload(mesh8, monkeypatch):
    """SiteStream staged rounds (uint16 buffers, PAD16 tails) must
    reproduce the resident sharded upload bit-for-bit."""
    from ngsdist_jax.config import Params

    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    S, N = 100, 6
    P = _probs(S, N, seed=5)
    np_dtype = np.float32
    pars = Params.__new__(Params)
    pars.n_ind = N
    pars.n_sites = S
    s_pad = 104  # 8 devices x 13
    stream = mh.SiteStream(pars, mesh8, np_dtype,
                           hostmem.pack23(P, np_dtype, s_pad),
                           s_pad, chunk=5, start=0, stop=s_pad)
    assert stream.slab_dtype == np.uint16
    assert stream.K == 2
    full = np.asarray(stream.global_array())
    got = np.zeros_like(full)
    for r in range(stream.n_rounds):
        rd = np.asarray(stream.round_data(r))
        lo = r * stream.chunk
        hi = min(lo + stream.chunk, stream.s_loc)
        rd4 = rd.reshape(stream.n_dev, stream.chunk, N, 3)
        f4 = got.reshape(stream.n_dev, stream.s_loc, N, 3)
        f4[:, lo:hi] = rd4[:, : hi - lo]
    np.testing.assert_array_equal(got, full)


def test_f64_never_quantizes(monkeypatch):
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    assert not hostmem.upload16_enabled(np.float64)
    monkeypatch.setenv("NGSDIST_UPLOAD23", "1")
    Q = hostmem.pack23(_probs(64, 4), np.float64)
    assert Q.dtype == np.float64  # forced 16 is a no-op off f32


def test_disabled_restores_f32_lane(monkeypatch):
    monkeypatch.setenv("NGSDIST_UPLOAD16", "0")
    Q = hostmem.pack23(_probs(64, 4), np.float32)
    assert Q.dtype == np.float32
