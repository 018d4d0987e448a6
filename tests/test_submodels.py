"""Extended evolutionary models (K80/F81/F84/TN93) — formulas, masks,
engine plumbing and CLI behavior."""

import gzip

import numpy as np
import pytest

from ngsdist_jax.config import NgsDistError, Params
from ngsdist_jax.core import bootstrap as bt
from ngsdist_jax.core import distance as dist
from ngsdist_jax.core import submodels as sm


# ---------------- classification & base counts ---------------------- #


def test_classify_sites():
    a1 = np.array([0, 1, 0, 0, 2, -1, 0], np.int8)  # A C A A G ? A
    a2 = np.array([2, 3, 1, 3, 0, 1, 0], np.int8)   # G T C T A C A
    m = sm.classify_sites(a1, a2)
    np.testing.assert_array_equal(m["ag"], [1, 0, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(m["ct"], [0, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(m["tv"], [0, 0, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(m["ok"], [1, 1, 1, 1, 1, 0, 0])


def test_encode_alleles_letters_and_codes():
    rows = [["c", "1", "A", "G"], ["c", "2", "0", "3"], ["c", "3", "N", "C"]]
    a1, a2 = sm.encode_alleles(rows)
    np.testing.assert_array_equal(a1, [0, 0, -1])
    np.testing.assert_array_equal(a2, [2, 3, 1])


def test_expected_base_counts_hard_genotypes():
    # site 0: alleles A,G; ind0 hom-A (g=0), ind1 hom-G (g=2)
    P = np.zeros((1, 2, 3))
    P[0, 0, 0] = 1.0
    P[0, 1, 2] = 1.0
    bc = sm.expected_base_counts(P, np.array([0], np.int8), np.array([2], np.int8))
    np.testing.assert_array_equal(bc[0, 0], [2, 0, 0, 0])  # two A
    np.testing.assert_array_equal(bc[0, 1], [0, 0, 2, 0])  # two G


# ---------------- formula properties -------------------------------- #


def test_f81_reduces_to_jc69_at_equal_freqs():
    p = np.array([0.05, 0.1, 0.2])
    pi = np.full((3, 4), 0.25)
    jc = -np.log(1 - p * 4 / 3) * 3 / 4
    np.testing.assert_allclose(sm.f81(p, pi), jc, rtol=1e-12)


def test_tn93_and_f84_reduce_to_k80():
    P, Q = 0.08, 0.06
    pi = np.full(4, 0.25)
    k = sm.k80(np.array(P), np.array(Q))
    t = sm.tn93(np.array(P / 2), np.array(P / 2), np.array(Q), pi)
    f = sm.f84(np.array(P), np.array(Q), pi)
    np.testing.assert_allclose(t, k, rtol=1e-12)
    np.testing.assert_allclose(f, k, rtol=1e-12)


def test_k80_zero_distance():
    assert sm.k80(np.array(0.0), np.array(0.0)) == 0.0


# ---------------- engine end-to-end --------------------------------- #


def _hard_probs(g):
    """one-hot [S, N, 3] from genotype matrix [S, N] of {0,1,2}."""
    S, N = g.shape
    P = np.zeros((S, N, 3))
    P[np.arange(S)[:, None], np.arange(N)[None, :], g] = 1.0
    return P


def test_k80_engine_matches_hand_counts():
    # 2 individuals, hom-only genotypes; transitions at A/G sites,
    # transversions at A/T sites.
    S = 40
    rng = np.random.default_rng(0)
    a1 = np.zeros(S, np.int8)              # allele1 = A
    a2 = np.where(np.arange(S) % 2 == 0, 2, 3).astype(np.int8)  # G or T
    g = np.zeros((S, 2), np.int64)
    diff = rng.random(S) < 0.3
    g[diff, 1] = 2                          # ind1 hom for allele2
    P = _hard_probs(g)

    n_ts = int(np.sum(diff & (a2 == 2)))
    n_tv = int(np.sum(diff & (a2 == 3)))
    d_hand = sm.k80(np.array(n_ts / S), np.array(n_tv / S))

    pars = Params(in_geno="x", n_ind=2, n_sites=S, out="y", seed=1,
                  indep_geno=True, in_probs=True, evol_model=3)
    mats = list(dist.iter_replicates(pars, P, [], S, alleles=(a1, a2)))
    np.testing.assert_allclose(mats[0][0, 1], d_hand, rtol=1e-10)


@pytest.mark.parametrize("model", [4, 5, 6])
@pytest.mark.parametrize("indep", [True, False])
def test_extended_models_engine_finite(model, indep):
    """GL data + random ACGT alleles: distances finite, symmetric, zero
    diagonal, for both the einsum and EM paths, incl. bootstrap."""
    rng = np.random.default_rng(model * 10 + indep)
    S, N = 60, 5
    P = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    a1, a2 = a[:, 0], a[:, 1]
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=3,
                  indep_geno=indep, in_probs=True, evol_model=model,
                  n_boot_rep=2, boot_block_size=5)
    n_trunc, maps = bt.site_maps(pars.seed, 2, S, 5)
    mats = list(dist.iter_replicates(pars, P, maps, n_trunc, alleles=(a1, a2)))
    assert len(mats) == 3
    for m in mats:
        assert np.all(np.isfinite(m)), m
        np.testing.assert_allclose(m, m.T, atol=1e-12)
        assert np.all(np.diag(m) == 0)
        assert np.all(m[np.triu_indices(N, 1)] > 0)
    del pairs


def test_pairwise_del_extended():
    rng = np.random.default_rng(9)
    S, N = 50, 4
    P = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    P[rng.random((S, N)) < 0.2] = 1 / 3  # missing
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=3,
                  indep_geno=True, in_probs=True, evol_model=6,
                  pairwise_del=True)
    mats = list(dist.iter_replicates(pars, P, [], S, alleles=(a[:, 0], a[:, 1])))
    assert np.all(np.isfinite(mats[0]))


# ---------------- CLI / runner behavior ----------------------------- #


def _write_inputs(tmp_path, rng, S, N):
    import numpy as np

    gp = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    geno = str(tmp_path / "gp.gz")
    with gzip.open(geno, "wt") as fh:
        for s in range(S):
            fh.write("\t".join(f"{x:.6f}" for x in gp[s].reshape(-1)) + "\n")
    pos = str(tmp_path / "pos.txt")
    bases = "ACGT"
    with open(pos, "w") as fh:
        for s in range(S):
            b = rng.choice(4, size=2, replace=False)
            fh.write(f"chr1\t{s+1}\t{bases[b[0]]}\t{bases[b[1]]}\n")
    return geno, pos


def test_runner_extended_model_jax_vs_exact(tmp_path):
    from ngsdist_jax import runner

    rng = np.random.default_rng(11)
    geno, pos = _write_inputs(tmp_path, rng, 30, 4)
    base = dict(in_geno=geno, in_probs=True, n_ind=4, n_sites=30,
                in_pos=pos, evol_model=5, seed=2, verbose=0)

    # exact engine: reference abort parity
    with pytest.raises(NgsDistError, match="HKY85"):
        runner.run(Params(out=str(tmp_path / "e.dist"), **base), engine="exact")

    # jax engine: implemented
    mats = runner.run(Params(out=str(tmp_path / "j.dist"), **base), engine="jax")
    assert np.all(np.isfinite(mats[0]))


def test_degenerate_base_composition_two_bases():
    """All sites A/C (e.g. ANGSD 0/1 numeric alleles): TN93/F84 purine
    terms vanish and the models reduce to their two-base limits rather
    than NaN."""
    pi = np.array([0.6, 0.4, 0.0, 0.0])  # only A and C present
    d_tn = sm.tn93(np.array(0.0), np.array(0.0), np.array(0.1), pi)
    assert np.isfinite(d_tn) and d_tn > 0
    d_f84 = sm.f84(np.array(0.0), np.array(0.1), pi)
    assert np.isfinite(d_f84) and d_f84 > 0


def test_f81_degenerate_composition():
    """Regression: E = 1 - sum(pi^2) = 0 (single-base composition) must
    give a vanishing distance, not 0/0 = nan."""
    pi = np.array([1.0, 0.0, 0.0, 0.0])
    assert sm.f81(np.array(0.0), pi) == 0.0


@pytest.mark.parametrize("model", [3, 4, 5, 6])
@pytest.mark.parametrize("indep,pairwise_del", [(True, False), (True, True),
                                                (False, False)])
def test_extended_mesh_matches_single(model, indep, pairwise_del):
    """Models 3-6 sharded over an 8-device mesh (class-masked stats +
    sharded per-pair base frequencies) must reproduce the single-device
    extended path, incl. bootstrap replicates."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    assert len(jax.devices()) >= 8
    mesh = pm.make_mesh(n_devices=8)
    rng = np.random.default_rng(100 * model + 2 * indep + pairwise_del)
    S, N = 61, 5  # not divisible by 8: padding path
    P = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    if pairwise_del:
        P[rng.random((S, N)) < 0.2] = 1 / 3
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    a1, a2 = a[:, 0].copy(), a[:, 1].copy()
    a1[::9] = -1  # some unclassifiable sites
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=7,
                  indep_geno=indep, in_probs=True, evol_model=model,
                  pairwise_del=pairwise_del, n_boot_rep=2, boot_block_size=6)
    n_trunc, maps = bt.site_maps(pars.seed, 2, S, 6)
    single = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                       alleles=(a1, a2)))
    sharded = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh,
                                        alleles=(a1, a2)))
    assert len(sharded) == len(single) == 3
    for x, y in zip(single, sharded):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-10)


def test_extended_chunked_streaming(monkeypatch):
    """Extended models under NGSDIST_DEVICE_BUDGET chunking must match
    the resident path."""
    rng = np.random.default_rng(31)
    S, N = 70, 4
    P = rng.dirichlet(np.ones(3) * 5, size=(S, N))
    a = np.array([rng.choice(4, size=2, replace=False) for _ in range(S)], np.int8)
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=3,
                  indep_geno=False, in_probs=True, evol_model=6,
                  n_boot_rep=2, boot_block_size=7)
    n_trunc, maps = bt.site_maps(pars.seed, 2, S, 7)
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    full = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                     alleles=(a[:, 0], a[:, 1])))
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(16 * N * 3 * 8))
    chunked = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                        alleles=(a[:, 0], a[:, 1])))
    for x, y in zip(full, chunked):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-11)
