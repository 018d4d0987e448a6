"""Mesh-sharded engine equivalence on a virtual 8-device CPU mesh.

The multi-device contract (SURVEY.md §2.3): sharding the site axis and
psum-merging per-shard sufficient statistics must reproduce the
single-device batched engine (which itself is pinned to the bit-exact
native oracle in test_jax_engine.py).  Reduction order differs only at
the shard-merge step, so float64 agreement is to ~1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ngsdist_jax.config import Params, default_score_matrix
from ngsdist_jax.core import bootstrap as bt
from ngsdist_jax.core import distance as dist
from ngsdist_jax.parallel import mesh as pm


def _rand_probs(rng, S, N, missing_frac=0.15):
    """Normal-space probability tensor with some missing (uniform) sites."""
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    miss = rng.random((S, N)) < missing_frac
    P[miss] = 1.0 / 3.0
    return P


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    return pm.make_mesh(n_devices=8)


@pytest.mark.parametrize("pairwise_del", [False, True])
def test_indep_sharded_matches_single(mesh8, pairwise_del):
    rng = np.random.default_rng(0)
    S, N = 103, 6  # deliberately not divisible by 8 (padding path)
    P = _rand_probs(rng, S, N)
    score = default_score_matrix()

    raw1, cnt1 = dist.indep_suffstats(
        jnp.asarray(P), jnp.asarray(score), pairwise_del
    )
    raw8, cnt8, _, _ = pm.sharded_suffstats(
        P, score, mesh8, indep=True, pairwise_del=pairwise_del
    )
    np.testing.assert_allclose(np.asarray(raw8), np.asarray(raw1), rtol=0, atol=1e-12)
    if pairwise_del:
        np.testing.assert_allclose(np.asarray(cnt8), np.asarray(cnt1), rtol=0, atol=0)


@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_sharded_matches_single(mesh8, pairwise_del):
    rng = np.random.default_rng(1)
    S, N = 57, 5
    P = _rand_probs(rng, S, N)
    score9 = jnp.asarray(default_score_matrix().reshape(-1))

    raw1, cnt1, _, _ = dist.em_suffstats(jnp.asarray(P), score9, pairwise_del)
    raw8, cnt8, _, _ = pm.sharded_suffstats(
        P, default_score_matrix(), mesh8, indep=False, pairwise_del=pairwise_del
    )
    np.testing.assert_allclose(np.asarray(raw8), np.asarray(raw1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(cnt8), np.asarray(cnt1), rtol=0, atol=1e-9)


def test_indep_weighted_sharded(mesh8):
    rng = np.random.default_rng(2)
    S, N = 64, 4
    P = _rand_probs(rng, S, N)
    score = default_score_matrix()
    w = rng.integers(0, 3, size=S).astype(np.float64)

    raw1, cnt1 = dist.indep_suffstats(
        jnp.asarray(P), jnp.asarray(score), True, jnp.asarray(w)
    )
    raw8, cnt8, _, _ = pm.sharded_suffstats(
        P, score, mesh8, indep=True, pairwise_del=True, site_weights=w
    )
    np.testing.assert_allclose(np.asarray(raw8), np.asarray(raw1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(cnt8), np.asarray(cnt1), rtol=0, atol=0)


def _pipeline_matrices(pars, P, mesh):
    n_trunc, maps = bt.site_maps(
        pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size
    )
    return list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh))


@pytest.mark.parametrize(
    "indep,pairwise_del", [(True, False), (True, True), (False, False), (False, True)]
)
def test_bootstrap_pipeline_sharded_matches_single(mesh8, indep, pairwise_del):
    rng = np.random.default_rng(3)
    S, N = 105, 5
    P = _rand_probs(rng, S, N)
    pars = Params(
        in_geno="x", n_ind=N, n_sites=S, out="y", seed=7,
        indep_geno=indep, pairwise_del=pairwise_del, in_probs=True,
        n_boot_rep=3, boot_block_size=10, evol_model=1,
    )
    ms = _pipeline_matrices(pars, P, None)
    mm = _pipeline_matrices(pars, P, mesh8)
    assert len(ms) == len(mm) == 4
    for a, b in zip(ms, mm):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-11)


@pytest.mark.parametrize(
    "indep,pairwise_del", [(True, False), (True, True), (False, False), (False, True)]
)
def test_sharded_streaming_matches_resident(mesh8, monkeypatch, indep, pairwise_del):
    """NGSDIST_DEVICE_BUDGET forced tiny: the sharded engine must
    iterate SiteStream rounds (several per device shard) and still
    reproduce the resident sharded pipeline, incl. bootstrap replicates
    (VERDICT round-1 item 3: per-device HBM no longer bounds genome
    length)."""
    from ngsdist_jax.parallel.multihost import SiteStream

    rng = np.random.default_rng(8)
    S, N = 141, 5
    P = _rand_probs(rng, S, N)
    pars = Params(
        in_geno="x", n_ind=N, n_sites=S, out="y", seed=11,
        indep_geno=indep, pairwise_del=pairwise_del, in_probs=True,
        n_boot_rep=3, boot_block_size=4, evol_model=1,
    )
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    resident = _pipeline_matrices(pars, P, mesh8)
    # ~4 sites per device-chunk -> multiple rounds per shard
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(4 * N * 3 * 8))
    stream = SiteStream.from_array(P, pars, mesh8, np.float64)
    assert not stream.resident and stream.n_rounds > 1
    streamed = _pipeline_matrices(pars, P, mesh8)
    assert len(streamed) == len(resident) == 4
    for a, b in zip(resident, streamed):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-11)


def test_extended_sharded_streaming_matches_resident(mesh8, monkeypatch):
    """Model 6 (TN93) under forced chunking on the mesh: class stats and
    base-frequency counts accumulate across rounds."""
    rng = np.random.default_rng(12)
    S, N = 77, 4
    P = _rand_probs(rng, S, N)
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    pars = Params(
        in_geno="x", n_ind=N, n_sites=S, out="y", seed=13,
        indep_geno=False, pairwise_del=True, in_probs=True,
        n_boot_rep=2, boot_block_size=5, evol_model=6,
    )
    n_trunc, maps = bt.site_maps(pars.seed, 2, S, 5)
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    resident = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh8,
                                         alleles=(a[:, 0], a[:, 1])))
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(4 * N * 3 * 8))
    streamed = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh8,
                                         alleles=(a[:, 0], a[:, 1])))
    assert len(streamed) == len(resident) == 3
    for a_, b_ in zip(resident, streamed):
        np.testing.assert_allclose(b_, a_, rtol=0, atol=1e-11)


@pytest.mark.parametrize(
    "indep,pairwise_del", [(True, False), (True, True), (False, False), (False, True)]
)
def test_2d_pairs_mesh_matches_1d(indep, pairwise_del):
    """A (sites=2, pairs=4) mesh — pair lists / output rows split over
    the second axis — must reproduce the 1-D 8-device pipeline
    (SURVEY.md §2.3 TP row), incl. bootstrap replicates."""
    mesh1 = pm.make_mesh(n_devices=8)
    mesh2 = pm.make_mesh(n_devices=8, pairs=4)
    assert pm.pairs_size(mesh2) == 4 and pm.sites_size(mesh2) == 2
    rng = np.random.default_rng(21)
    S, N = 53, 6  # N=6: 15 pairs (not divisible by 4), rows ragged too
    P = _rand_probs(rng, S, N)
    pars = Params(
        in_geno="x", n_ind=N, n_sites=S, out="y", seed=5,
        indep_geno=indep, pairwise_del=pairwise_del, in_probs=True,
        n_boot_rep=2, boot_block_size=4, evol_model=1,
    )
    a = _pipeline_matrices(pars, P, mesh1)
    b = _pipeline_matrices(pars, P, mesh2)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-11)


def test_2d_pairs_mesh_extended_model():
    """TN93 on the (2,4) mesh: class stats + rows-sliced base counts."""
    mesh2 = pm.make_mesh(n_devices=8, pairs=4)
    rng = np.random.default_rng(22)
    S, N = 41, 5
    P = _rand_probs(rng, S, N)
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    pars = Params(
        in_geno="x", n_ind=N, n_sites=S, out="y", seed=5,
        indep_geno=False, pairwise_del=True, in_probs=True, evol_model=6,
    )
    single = list(dist.iter_replicates(pars, P, [], S, alleles=(a[:, 0], a[:, 1])))
    sharded = list(dist.iter_replicates(pars, P, [], S, mesh=mesh2,
                                        alleles=(a[:, 0], a[:, 1])))
    np.testing.assert_allclose(sharded[0], single[0], rtol=0, atol=1e-10)


def test_single_device_mesh_ok():
    """A 1-device mesh must work (degenerate scale-out)."""
    rng = np.random.default_rng(4)
    P = _rand_probs(rng, 30, 4)
    m1 = pm.make_mesh(n_devices=1)
    raw1, cnt1 = dist.indep_suffstats(
        jnp.asarray(P), jnp.asarray(default_score_matrix()), True
    )
    raw, cnt, _, _ = pm.sharded_suffstats(
        P, default_score_matrix(), m1, indep=True, pairwise_del=True
    )
    np.testing.assert_allclose(np.asarray(raw), np.asarray(raw1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(cnt), np.asarray(cnt1), atol=0)


def test_pair_block_tables_cover_each_devices_pairs():
    """Every device's contiguous pair slice must be covered by its block
    sublist; padding entries are the never-read lower-tri block (1, 0).
    Pair-list padding duplicates the LAST real pair, so it adds no
    extra block to the last device's table."""
    from ngsdist_jax.core.distance import _pair_indices
    from ngsdist_jax.parallel.mesh import (_pair_block_tables,
                                           _pair_block_tables_cached)

    for N, p, B in [(300, 2, 128), (515, 4, 128), (40, 2, 128), (1030, 8, 128)]:
        I, J = _pair_indices(N)
        n_pairs = len(I)
        n_pad = -(-n_pairs // p) * p
        I = np.concatenate([I, np.full(n_pad - n_pairs, I[-1], np.int32)])
        J = np.concatenate([J, np.full(n_pad - n_pairs, J[-1], np.int32)])
        IBt, JBt = _pair_block_tables(I, J, p, B)
        # the cached builder (run constants only) must agree
        IBc, JBc = _pair_block_tables_cached(N, p, B)
        np.testing.assert_array_equal(np.asarray(IBc), IBt)
        np.testing.assert_array_equal(np.asarray(JBc), JBt)
        assert IBt.shape == JBt.shape and IBt.shape[0] == p
        per = n_pad // p
        for d in range(p):
            have = set(zip(IBt[d].tolist(), JBt[d].tolist()))
            for k in range(d * per, (d + 1) * per):
                assert (int(I[k]) // B, int(J[k]) // B) in have, (N, p, d)
            for (bi, bj) in have:
                # entries are valid upper blocks or the (1, 0) padding
                assert bi <= bj or (bi, bj) == (1, 0), (N, p, d, bi, bj)


def test_streamed_indep_bootstrap_single_pass(tmp_path, monkeypatch):
    """Streamed indep bootstrap: ONE data pass builds per-round block
    partials; every replicate is a resummation (no per-replicate data
    passes), and results match the resident engine."""
    from ngsdist_jax.config import Params
    from ngsdist_jax.core import bootstrap as bt
    from ngsdist_jax.core import distance as dist
    from ngsdist_jax.parallel import mesh as pm

    mesh = pm.make_mesh(n_devices=4)
    rng = np.random.default_rng(60)
    S, N, bs, R = 94, 5, 4, 3
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[rng.random((S, N)) < 0.15] = 1 / 3
    pars = Params(in_geno="x", n_ind=N, n_sites=S, in_probs=True, out="y",
                  seed=11, verbose=0, indep_geno=True, pairwise_del=True,
                  n_boot_rep=R, boot_block_size=bs)
    n_trunc, maps = bt.site_maps(pars.seed, R, S, bs)

    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    resident = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh))

    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(8 * N * 3 * 8))
    calls = {"n": 0}
    orig = pm.sharded_suffstats

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(pm, "sharded_suffstats", spy)
    streamed = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh))
    assert len(streamed) == len(resident) == R + 1
    for a, b in zip(resident, streamed):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)

    # one partials call per round plus at most two tail rounds — NOT
    # (R+1) passes over all rounds
    from ngsdist_jax.parallel.multihost import SiteStream

    st = SiteStream.from_array(P, pars, mesh, np.float64)
    assert not st.resident
    assert calls["n"] <= st.n_rounds + 2, (calls["n"], st.n_rounds)


def _kernel_interpret(monkeypatch, block=16):
    """Route the engine's EM path through the kernel in interpret mode
    (the CPU has no GPU to compile it for)."""
    import functools

    from ngsdist_jax.ops import em_kernel as ek

    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: True)
    monkeypatch.setattr(ek, "em_raw_cnt", functools.partial(
        ek.em_raw_cnt, interpret=True, block=block))


@pytest.mark.parametrize("pairwise_del", [False, True])
def test_em_kernel_sites_mesh(monkeypatch, pairwise_del):
    """The EM kernel (interpret mode) under shard_map on the 1-D sites
    mesh, with bootstrap weights, reproduces the XLA scan."""
    rng = np.random.default_rng(62)
    S, N = 29, 21
    P = _rand_probs(rng, S, N)
    w = rng.integers(0, 3, size=S).astype(np.float64)
    score = default_score_matrix()
    mesh = pm.make_mesh(n_devices=4)
    ref = pm.sharded_suffstats(P, score, mesh, indep=False,
                               pairwise_del=pairwise_del, site_weights=w,
                               dtype=jnp.float64)
    _kernel_interpret(monkeypatch)
    got = pm.sharded_suffstats(P, score, mesh, indep=False,
                               pairwise_del=pairwise_del, site_weights=w,
                               dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=0, atol=1e-12)


def test_em_kernel_branch_wiring_p2(monkeypatch):
    """The 2-D mesh EM kernel branch — table sharding over the pairs
    axis, per-device block sublists, pair-slice extraction, psum and
    out_specs.  The interpreter cannot index with tables that vary over
    the pairs axis, so the kernel runs (interpret mode) over the full
    block enumeration and then keeps only the blocks of this device's
    sublist, zeroing the rest: wrong tables corrupt the comparison."""
    from ngsdist_jax.ops import em_kernel as ek

    B = 16
    kernel = ek.em_raw_cnt

    def sublist_kernel(P, score9, pairwise_del, site_weights=None,
                       vma=None, blocks=None, **kw):
        raw, cnt = kernel(P, score9, pairwise_del, site_weights=site_weights,
                          vma=vma, block=B, interpret=True)
        if blocks is not None:
            N = P.shape[1]
            ib, jb = blocks
            bi = jnp.arange(N)[:, None] // B
            bj = jnp.arange(N)[None, :] // B
            keep = jnp.zeros((N, N), bool)
            for g in range(int(ib.shape[0])):
                keep = keep | ((bi == ib[g]) & (bj == jb[g]))
            raw = jnp.where(keep, raw, 0)
            cnt = jnp.where(keep, cnt, 0)
        return raw, cnt

    rng = np.random.default_rng(61)
    S, N = 24, 40  # three block rows at B=16
    P = rng.dirichlet(np.ones(3), size=(S, N))
    score = default_score_matrix()
    mesh2 = pm.make_mesh(n_devices=4, pairs=2)

    ref_raw, ref_cnt, _, _ = pm.sharded_suffstats(
        P, score, mesh2, indep=False, pairwise_del=True, dtype=jnp.float64)

    monkeypatch.setattr(ek, "em_raw_cnt", sublist_kernel)
    monkeypatch.setattr(ek, "choose_block", lambda n: B)
    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: True)
    pm._pair_block_tables_cached.cache_clear()
    got_raw, got_cnt, _, _ = pm.sharded_suffstats(
        P, score, mesh2, indep=False, pairwise_del=True, dtype=jnp.float64)
    pm._pair_block_tables_cached.cache_clear()

    np.testing.assert_allclose(np.asarray(got_raw), np.asarray(ref_raw),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_cnt), np.asarray(ref_cnt),
                               rtol=1e-9, atol=1e-12)


def test_em_kernel_choice_follows_backend_and_dtype(monkeypatch):
    """GPU + float32 -> kernel; CPU or float64 -> the XLA scan.  No
    environment variable takes part."""
    assert not dist.use_em_kernel(jnp.float32)  # this CPU backend
    assert not dist.use_em_kernel(jnp.float64)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dist.use_em_kernel(jnp.float32)
    assert dist.use_em_kernel(np.float32)
    assert not dist.use_em_kernel(jnp.float64)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not dist.use_em_kernel(jnp.float32)


def test_sharded_em_kernel_choice_per_call(mesh8, monkeypatch):
    """The kernel choice is made per call outside jit and passed as a
    static argument, so it is never frozen into a cached trace."""
    seen = []
    orig = pm._em_sharded

    def spy(*a, use_kernel=False, **kw):
        seen.append(use_kernel)
        return orig(*a, use_kernel=False, **kw)  # CPU: run the scan

    monkeypatch.setattr(pm, "_em_sharded", spy)
    rng = np.random.default_rng(6)
    P = _rand_probs(rng, 16, 3)
    score = default_score_matrix()
    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: True)
    pm.sharded_suffstats(P, score, mesh8, indep=False, pairwise_del=True)
    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: False)
    pm.sharded_suffstats(P, score, mesh8, indep=False, pairwise_del=True)
    # block partials always take the scan
    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: True)
    pm.sharded_suffstats(P, score, mesh8, indep=False, pairwise_del=True,
                         n_blocks=2, block_size=8)
    assert seen == [True, False, False]
