"""The EM kernel (ops/em_kernel.py) in interpret mode vs the batched EM.

The kernel reformulates the per-(pair, site) EM as elementwise powers of
the max-normalised joint weights; the update order, convergence rule
(|Δloglik| < 0.001 as a ratio test) and iteration cap match core/em.py,
so float64 interpret-mode results agree to reduction-order rounding.
Compiled on the card, the same checks run as the `gpu`-marked test at
the end of this file.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ngsdist_jax.config import Params, default_score_matrix
from ngsdist_jax.core import distance as dist
from ngsdist_jax.core import em as em_mod
from ngsdist_jax.ops import em_kernel as ek

SCORE9 = default_score_matrix().reshape(-1)


def _rand_probs(rng, S, N, missing_frac=0.15):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < missing_frac] = 1.0 / 3.0
    return P


def _oracle(P, pairwise_del, w=None):
    """Pair-vector (raw, cnt) straight from core/em.py: per-(pair, site)
    EM contributions, lanes with an all-zero row excluded (the kernel's
    dead lanes), missing rows excluded under pairwise deletion."""
    S, N, _ = P.shape
    I, J = dist._pair_indices(N)
    Pj = jnp.asarray(P)
    contrib = np.asarray(em_mod.em_pair_site_contribs(
        Pj[:, I], Pj[:, J], jnp.asarray(SCORE9)))
    alive = ~np.all(P == 0, axis=-1)
    m = (alive[:, I] & alive[:, J]).astype(np.float64)
    if pairwise_del:
        valid = ~np.asarray(dist.missing_mask(Pj))
        m = m * (valid[:, I] & valid[:, J])
    w = np.ones(S) if w is None else np.asarray(w, np.float64)
    return (np.sum(w[:, None] * m * contrib, axis=0),
            np.sum(w[:, None] * m, axis=0))


def _hard(rng, S, N):
    g = rng.integers(0, 3, size=(S, N))
    P = np.zeros((S, N, 3))
    P[np.arange(S)[:, None], np.arange(N)[None, :], g] = 1.0
    P[0, :] = 1.0 / 3.0  # one fully-missing site
    return P


def _slow(S, N):
    # channels (1, 0.94, 0.93) converge slowest under the ratio test
    # (k* = 39, deep in the 6th exit-check chunk); fast lanes mixed in
    p = np.array([1.0, 0.94, 0.93])
    P = np.tile(p / p.sum(), (S, N, 1))
    P[:, 0] = np.array([1.0, 1e-9, 1e-9]) / (1.0 + 2e-9)
    return P


def _zero_rows(rng, S, N):
    P = _rand_probs(rng, S, N)
    P[3, 2] = 0.0    # data-borne (0,0,0) triples
    P[7, :] = 0.0    # an empty-line site
    return P


def _neg_rounding(rng, S, N):
    # a channel reconstructed as 1 - p0 - p1 can land a hair below 0
    P = _rand_probs(rng, S, N)
    P[::3, ::2, 2] = -1.9e-8
    return P


# name -> (builder(rng) -> (P, weights), pairwise_del, kernel kwargs)
CASES = {
    "below-tile": (lambda r: (_rand_probs(r, 37, 10), None), False, {}),
    "below-tile-pd": (lambda r: (_rand_probs(r, 37, 10), None), True, {}),
    "equal-tile-int-weights": (
        lambda r: (_rand_probs(r, 24, 16), r.integers(0, 3, 24)), True,
        {"block": 16}),
    "ragged-float-weights": (
        lambda r: (_rand_probs(r, 24, 20),
                   np.where(np.arange(24) % 5 == 0, 0.0, r.random(24))),
        True, {"block": 16}),
    "default-block-32": (lambda r: (_rand_probs(r, 9, 32), None), True, {}),
    "hard-genotypes": (lambda r: (_hard(r, 16, 6), None), False, {}),
    "hard-genotypes-pd": (lambda r: (_hard(r, 16, 6), None), True, {}),
    "slowest-lanes": (lambda r: (_slow(8, 4), None), False, {}),
    "zero-rows": (lambda r: (_zero_rows(r, 12, 9), None), False, {}),
    "zero-rows-pd": (lambda r: (_zero_rows(r, 12, 9), None), True, {}),
    "site-split": (lambda r: (_rand_probs(r, 37, 12), r.integers(0, 4, 37)),
                   True, {"n_split": 3}),
    "negative-rounding": (lambda r: (_neg_rounding(r, 15, 9), None), True,
                          {}),
    "multi-block": (lambda r: (_rand_probs(r, 10, 40), None), False,
                    {"block": 16}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_batched_em(case):
    build, pd, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    P, w = build(rng)
    S, N, _ = P.shape
    raw, cnt = ek.em_raw_cnt(jnp.asarray(P), SCORE9, pd, site_weights=w,
                             interpret=True, **kw)
    iu = np.triu_indices(N, k=1)
    got_raw, got_cnt = np.asarray(raw)[iu], np.asarray(cnt)[iu]

    P0 = np.maximum(P, 0.0)  # the kernel's reading of rounding below 0
    ref_raw, ref_cnt = _oracle(P0, pd, w)
    np.testing.assert_allclose(got_raw, ref_raw, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_cnt, ref_cnt, rtol=0, atol=1e-9)

    # the XLA scan agrees wherever no data-borne zero row is involved
    # (the scan counts such lanes; the engine NaN-poisons them anyway)
    sw = None if w is None else np.asarray(w, np.float64)
    scan_raw, scan_cnt, _, _ = dist.em_suffstats(
        jnp.asarray(P0), jnp.asarray(SCORE9), pd, site_weights=sw)
    z = np.asarray(dist._em_zero_rows(jnp.asarray(P0)))
    I, J = dist._pair_indices(N)
    clean = ~(z[I] | z[J]) | pd
    np.testing.assert_allclose(got_raw[clean], np.asarray(scan_raw)[clean],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_cnt[clean], np.asarray(scan_cnt)[clean],
                               rtol=0, atol=1e-9)


def test_kernel_iteration_cap(monkeypatch):
    """Lanes that never meet the tolerance stop at the iteration cap in
    both engines.  Real data converges within 39 steps at tole=1e-3, so
    the cap is lowered to 8 (7 | 8 - 1 keeps the chunked exit exact)."""
    monkeypatch.setattr(ek, "EM_MAX_ITER", 8)
    monkeypatch.setattr(em_mod, "EM_MAX_ITER", 8)
    ek._em_blocks.clear_cache()
    dist._em_scan.clear_cache()
    try:
        P = _slow(6, 5)
        raw, cnt = ek.em_raw_cnt(jnp.asarray(P), SCORE9, False,
                                 interpret=True)
        ref_raw, ref_cnt = _oracle(P, False)
        iu = np.triu_indices(5, k=1)
        np.testing.assert_allclose(np.asarray(raw)[iu], ref_raw,
                                   rtol=1e-9, atol=1e-9)
        # capped lanes differ from the converged ones
        monkeypatch.setattr(em_mod, "EM_MAX_ITER", 50)
        full_raw, _ = _oracle(P, False)
        assert np.abs(full_raw - ref_raw).max() > 1e-6
    finally:
        ek._em_blocks.clear_cache()
        dist._em_scan.clear_cache()


def test_kernel_block_sublists():
    """The 2-D mesh gives each device a SUBLIST of upper-tri blocks; the
    union of two sublists — the shorter padded with the never-read
    lower-triangle block (1, 0) — reproduces the full enumeration on
    the pairs each covers."""
    rng = np.random.default_rng(3)
    S, N, B = 16, 40, 16  # N_pad 48 -> nb=3 -> 6 upper blocks
    P = jnp.asarray(_rand_probs(rng, S, N))
    full_raw, full_cnt = ek.em_raw_cnt(P, SCORE9, True, block=B,
                                       interpret=True)
    IB, JB = ek.upper_blocks(3)
    halves = [(IB[:4], JB[:4]),
              (np.append(IB[4:], [1, 1]).astype(np.int32),
               np.append(JB[4:], [0, 0]).astype(np.int32))]
    covered = np.zeros((N, N), bool)
    for ib, jb in halves:
        raw, cnt = ek.em_raw_cnt(P, SCORE9, True, block=B, interpret=True,
                                 blocks=(ib, jb))
        for bi, bj in zip(ib.tolist(), jb.tolist()):
            if bi > bj:
                continue  # the padding block
            sl = (slice(bi * B, (bi + 1) * B), slice(bj * B, (bj + 1) * B))
            np.testing.assert_allclose(np.asarray(raw)[sl],
                                       np.asarray(full_raw)[sl], rtol=1e-12)
            np.testing.assert_allclose(np.asarray(cnt)[sl],
                                       np.asarray(full_cnt)[sl], rtol=0)
            covered[sl] = True
    assert covered[np.triu_indices(N, k=1)].all()


def test_kernel_weighted_replicates_share_one_compile():
    """Bootstrap replicates differ only in weight VALUES: every
    replicate reuses the one compiled kernel shape."""
    rng = np.random.default_rng(4)
    P = jnp.asarray(_rand_probs(rng, 20, 5))
    before = ek._em_blocks._cache_size()
    outs = []
    for _ in range(3):
        w = rng.integers(0, 4, size=20).astype(np.float64)
        raw, _ = ek.em_raw_cnt(P, SCORE9, False, site_weights=w,
                               interpret=True)
        outs.append(np.asarray(raw))
    assert ek._em_blocks._cache_size() - before <= 1
    assert not np.allclose(outs[0], outs[1])  # weights actually applied


def test_choose_block_and_split():
    assert ek.choose_block(5) == 16
    assert ek.choose_block(16) == 16
    assert ek.choose_block(17) == 32
    assert ek.choose_block(1024) == ek.DEFAULT_BLOCK
    # a cohort of 1,024 fills the card with block pairs alone ...
    nb = 1024 // ek.DEFAULT_BLOCK
    G = nb * (nb + 1) // 2
    assert G * ek.choose_split(16384, G) >= ek.TARGET_PROGRAMS // 2
    # ... small cohorts split the sites, never below the minimum range
    assert ek.choose_split(4096, 1) == 4096 // ek.MIN_SPLIT_SITES
    assert ek.choose_split(100, 1) == 1


def test_kernel_tables_and_padding_shapes():
    """Wrapper shapes: N and S are padded to the block and the split,
    outputs are trimmed back to [N, N], and the upper-block table is
    the row-major upper triangle."""
    IB, JB = ek.upper_blocks(3)
    assert list(zip(IB.tolist(), JB.tolist())) == [
        (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    P = jnp.asarray(_rand_probs(np.random.default_rng(5), 11, 7))
    raw, cnt = ek.em_raw_cnt(P, SCORE9, True, interpret=True, n_split=2)
    assert raw.shape == cnt.shape == (7, 7)
    assert raw.dtype == P.dtype


@pytest.mark.parametrize("pairwise_del,n_boot", [
    (False, 0), (True, 0), (True, 2), (False, 2)])
def test_engine_kernel_route_matches_scan(monkeypatch, pairwise_del, n_boot):
    """iter_replicates through the kernel (interpret mode) gives the
    same matrices as through the XLA scan, bootstrap replicates and the
    zero-row NaN poison included."""
    from ngsdist_jax.core import bootstrap as bt

    rng = np.random.default_rng(7)
    S, N, bs = 40, 7, 8
    P = _rand_probs(rng, S, N)
    P[5, 3] = 0.0  # a data-borne zero row: poisons pairs of ind 3
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=9,
                  indep_geno=False, pairwise_del=pairwise_del,
                  in_probs=True, n_boot_rep=n_boot, boot_block_size=bs)
    n_trunc, maps = bt.site_maps(pars.seed, n_boot, S, bs) if n_boot \
        else (S, [])
    ref = list(dist.iter_replicates(pars, P, maps, n_trunc))
    monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: True)
    monkeypatch.setattr(ek, "em_raw_cnt",
                        functools.partial(ek.em_raw_cnt, interpret=True))
    got = list(dist.iter_replicates(pars, P, maps, n_trunc))
    assert len(got) == len(ref) == n_boot + 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    if not pairwise_del:
        assert np.isnan(got[0][3, 0]) and not np.isnan(got[0][1, 0])


@pytest.mark.gpu
def test_kernel_on_card_matches_scan(gpu):
    """Compiled for the card at a real width: the kernel against the
    XLA scan on the same f32 data (chip_smoke.py runs the same check)."""
    import chip_smoke

    err = chip_smoke.kernel_vs_scan(n_ind=256, n_sites=2048, seed=1)
    assert err["dist_max_abs"] <= chip_smoke.TOL_EM_F32, err
