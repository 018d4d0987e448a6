"""2-of-3 component uploads (NGSDIST_UPLOAD23).

The reader normalizes every genotype triple to sum 1
(/root/reference/shared/read_data.cpp:40,98 post_prob; one-hot and
uniform triples exactly), so f32 paths upload only [.., 2] components
and reconstruct p2 = 1 - p0 - p1 on device — 1.5x fewer bytes over the
host link.  These tests pin (a) the reconstruction error stays below
the engines' f32 floor, (b) missing/valid classification is unchanged
(EPSILON=1e-5 is 100x above the reconstruction error), (c) padded rows
— which expand to the valid-looking (0, 0, 1) — stay inert on the mesh
because every mesh reduction is mask-weighted, and (d) the threaded
host casts accept the strided [:, :, :2] views.
"""

import numpy as np
import pytest

import jax
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
    P[::17] = 1.0 / 3.0          # missing triples
    P[3::29, N // 2] = [0, 0, 1]  # one-hot hom (p0 = p1 = 0)
    P[7::31, N // 3] = [1, 0, 0]
    # data-borne ALL-ZERO triples: empty-line text sites keep the
    # reader's -BIGNEG prefill, whose exp() is (0,0,0) — in 2 components
    # indistinguishable from the (0,0,1) one-hot above without the
    # PAD23 sentinel (pack23)
    P[11::37, N // 4] = [0, 0, 0]
    P[5::41] = 0.0               # whole empty-line site
    return P


def test_put_probs_matches_full_upload(monkeypatch):
    P = _probs(400, 10)
    monkeypatch.setenv("NGSDIST_UPLOAD23", "0")
    P_full = np.asarray(dist.put_probs(P, jnp.float32))
    monkeypatch.setenv("NGSDIST_UPLOAD23", "1")
    P_23 = np.asarray(dist.put_probs(P, jnp.float32))
    assert P_23.shape == P_full.shape
    # components 0/1 are the same cast; p2 reconstructs within ~1e-7
    np.testing.assert_array_equal(P_23[..., :2], P_full[..., :2])
    assert np.max(np.abs(P_23[..., 2] - P_full[..., 2])) < 1e-6
    # one-hot / uniform triples reconstruct exactly
    assert (P_23[3::29, 10 // 2] == np.array([0, 0, 1], np.float32)).all()


def test_suffstats_and_missing_unchanged(monkeypatch):
    P = _probs(500, 12, seed=1)
    score = jnp.asarray(SCORE, jnp.float32)
    out = {}
    for env in ("0", "1"):
        monkeypatch.setenv("NGSDIST_UPLOAD23", env)
        Pd = dist.put_probs(P, jnp.float32)
        raw, cnt = dist.indep_suffstats(Pd, score, True)
        out[env] = (np.asarray(raw, np.float64), np.asarray(cnt, np.float64))
    r0, c0 = out["0"]
    r1, c1 = out["1"]
    # valid-site counts (EPSILON-tolerance missing test) must not move.
    # Caveat on the exact equality: reconstruction shifts a triple's
    # missing classification only when its component spread lies within
    # ~1e-7 of EPSILON=1e-5 — a measure-~0 set the fixed-seed dirichlet
    # draws stay clear of (adversarial data could land there; these
    # asserts pin the generated inputs, not that impossibility).
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_allclose(r1, r0, rtol=5e-7, atol=1e-9)


def test_pack23_marks_data_zero_triples():
    """(0,0,0) triples — NOT padding — must round-trip through the
    sentinel: without it they expand to confident (0,0,1) hom-alt
    genotypes (round-3 review finding, reproduced end-to-end on an
    empty-line .geno.gz)."""
    P = _probs(120, 8, seed=4)
    packed = hostmem.pack23(P, np.float32)
    assert packed.shape == (120, 8, 2)
    zz = (P == 0).all(axis=-1)
    assert zz.any()
    np.testing.assert_array_equal(packed[zz][:, 0], hostmem.PAD23)
    got = np.asarray(dist.expand23(jnp.asarray(packed)))
    np.testing.assert_array_equal(got[zz], 0.0)
    # one-hot (0,0,1) survives as a REAL genotype
    oh = (P[..., 2] == 1) & ~zz
    assert oh.any()
    np.testing.assert_array_equal(
        got[oh], np.tile(np.float32([0, 0, 1]), (int(oh.sum()), 1)))


def test_pack23_does_not_mutate_shared_input():
    """Forced 2-comp upload of an already-f32 tensor: parallel_cast_pad
    returns the caller's view, which pack23 must copy before writing
    sentinels."""
    P = _probs(50, 4, seed=5).astype(np.float32)
    snap = P.copy()
    packed = hostmem.pack23(P, np.float32)
    np.testing.assert_array_equal(P, snap)
    assert (packed[:, :, 0] == hostmem.PAD23).any()


def test_empty_line_gz_e2e(tmp_path, monkeypatch):
    """Empty lines in a text genome consume the site as missing
    (reference read_data control flow); upload23 must not resurrect
    them as hom-alt calls.  f32 end-to-end through the runner."""
    import gzip

    from ngsdist_jax import runner
    from ngsdist_jax.config import Params

    jax.config.update("jax_enable_x64", False)
    try:
        N, S = 5, 40
        rng = np.random.default_rng(3)
        lines = []
        for s in range(S):
            if s in (7, 23):
                lines.append("")
                continue
            g = rng.dirichlet(np.ones(3), size=N).ravel()
            lines.append("\t".join(f"{x:.6f}" for x in g))
        geno = tmp_path / "empty.geno.gz"
        with gzip.open(geno, "wt") as fh:
            fh.write("\n".join(lines) + "\n")
        out = {}
        for env in ("0", "1"):
            monkeypatch.setenv("NGSDIST_UPLOAD23", env)
            pars = Params(in_geno=str(geno), in_probs=True, n_ind=N,
                          n_sites=S, indep_geno=True, pairwise_del=True,
                          seed=1, verbose=0,
                          out=str(tmp_path / f"e_{env}.dist"))
            pars.validate(); pars.finalize()
            runner.run(pars, engine="jax")
            rows = [l.split("\t")[1:]
                    for l in open(tmp_path / f"e_{env}.dist") if "\t" in l]
            out[env] = np.array(rows, np.float64)
        np.testing.assert_allclose(out["1"], out["0"], rtol=0, atol=1e-6)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_x64_auto_disables():
    assert not hostmem.upload23_enabled(np.float64)
    assert hostmem.upload23_enabled(np.float32)


def test_parallel_casts_handle_strided_views(monkeypatch):
    # force the threaded path even for small arrays
    monkeypatch.setattr(hostmem, "_MIN_PARALLEL_BYTES", 0)
    a = np.arange(5 * 7 * 3, dtype=np.float64).reshape(5, 7, 3) / 10.0
    v = a[:, :, :2]
    np.testing.assert_array_equal(
        hostmem.parallel_astype(v, np.float32), v.astype(np.float32))
    got = hostmem.parallel_cast_pad(v, np.float32, 9)
    np.testing.assert_array_equal(got[:5], v.astype(np.float32))
    assert not got[5:].any()


def test_mesh_sharded_pad_rows_inert(mesh8, monkeypatch):
    """S deliberately not divisible by 8: pad rows expand to (0,0,1)
    but the mask-weighted mesh reductions must match the full upload
    (cnt exactly — the EPSILON classification is tolerance-robust)."""
    S, N = 301, 9
    P = _probs(S, N, seed=2)
    out = {}
    for env in ("0", "1"):
        monkeypatch.setenv("NGSDIST_UPLOAD23", env)
        raw, cnt, _, _ = pm.sharded_suffstats(
            P, SCORE, mesh8, indep=True, pairwise_del=True,
            dtype=jnp.float32)
        out[env] = (np.asarray(raw, np.float64), np.asarray(cnt, np.float64))
    r0, c0 = out["0"]
    r1, c1 = out["1"]
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_allclose(r1, r0, rtol=5e-7, atol=1e-9)


def test_streamed_bootstrap_pad23_sentinel(monkeypatch):
    """The streamed single-pass indep bootstrap builds block partials
    WITHOUT site weights — it relies on padded rows being all-zero.
    With 2-component uploads the padding must round-trip through the
    PAD23 sentinel (mesh.expand23_sharded), or (0,0,1) ghost rows
    corrupt the partials.  f32 end-to-end, upload23 on vs off."""
    from ngsdist_jax.config import Params
    from ngsdist_jax.core import bootstrap as bt

    jax.config.update("jax_enable_x64", False)
    try:
        mesh = pm.make_mesh(n_devices=4)
        rng = np.random.default_rng(61)
        S, N, bs, R = 94, 5, 4, 3
        P = rng.dirichlet(np.ones(3), size=(S, N))
        P[rng.random((S, N)) < 0.15] = 1 / 3
        pars = Params(in_geno="x", n_ind=N, n_sites=S, in_probs=True,
                      out="y", seed=11, verbose=0, indep_geno=True,
                      pairwise_del=True, n_boot_rep=R, boot_block_size=bs)
        n_trunc, maps = bt.site_maps(pars.seed, R, S, bs)
        # force streaming rounds (tiny device budget)
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(8 * N * 3 * 8))
        out = {}
        for env in ("0", "1"):
            monkeypatch.setenv("NGSDIST_UPLOAD23", env)
            out[env] = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                                 mesh=mesh))
        assert len(out["0"]) == len(out["1"]) == R + 1
        for a, b in zip(out["0"], out["1"]):
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-8)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_sitestream_rounds_match_full_upload(mesh8, monkeypatch):
    """SiteStream stores 2-component slabs (1/3 less host RAM) and
    expands per round on device; streamed suffstats must match the
    3-component stream."""
    from ngsdist_jax.config import Params

    S, N = 203, 6
    P = _probs(S, N, seed=3)
    pars = Params()
    pars.n_ind, pars.n_sites = N, S
    out = {}
    for env in ("0", "1"):
        monkeypatch.setenv("NGSDIST_UPLOAD23", env)
        stream = mh.SiteStream.from_array(P, pars, mesh8, np.float32)
        assert stream.K == (2 if env == "1" else 3)
        acc_raw = acc_cnt = None
        for r in range(stream.n_rounds):
            Pr = stream.round_data(r)
            assert int(Pr.shape[-1]) == 3
            w = stream.round_cols(r, np.ones((S,), np.float64))
            raw, cnt, _, _ = pm.sharded_suffstats(
                Pr, SCORE, mesh8, indep=True, pairwise_del=True,
                site_weights=w, dtype=jnp.float32,
                n_sites=int(Pr.shape[0]))
            raw = np.asarray(raw, np.float64)
            cnt = np.asarray(cnt, np.float64)
            acc_raw = raw if acc_raw is None else acc_raw + raw
            acc_cnt = cnt if acc_cnt is None else acc_cnt + cnt
        out[env] = (acc_raw, acc_cnt)
    r0, c0 = out["0"]
    r1, c1 = out["1"]
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_allclose(r1, r0, rtol=5e-7, atol=1e-9)
