"""JAX engine vs exact engine: the batched XLA path must agree with the
bit-exact CPU oracle to float64 reduction-order tolerance on every
configuration, including bootstrap partial-sum resummation."""

import json
import os

import numpy as np
import pytest

from ngsdist_jax import cli, runner
from ngsdist_jax.config import Params
from ngsdist_jax.core import bootstrap as bt
from ngsdist_jax.core import distance as dist
from ngsdist_jax.core import exact as exact_engine

from conftest import DATA_DIR, FIXTURES

import jax
import jax.numpy as jnp

with open(os.path.join(FIXTURES, "manifest.json")) as fh:
    MANIFEST = json.load(fh)


def _run_both(name, tmp_path, monkeypatch):
    cfg = MANIFEST[name]
    monkeypatch.chdir(DATA_DIR)
    outs = {}
    for engine in ("exact", "jax"):
        out = tmp_path / f"{name}.{engine}.dist"
        argv = [a.replace("{OUT}", str(out)) for a in cfg["args"]]
        pars, _ = cli.parse_args(argv)
        pars.verbose = 0
        mats = runner.run(pars, engine=engine)
        outs[engine] = mats
    return outs


# A representative subset covering every code path (indep/EM, masks,
# bootstrap partials, call_geno, models, tot_sites, binary/text).
SUBSET = [
    "T", "T_m0", "T_m2", "T_avg", "T_tot", "T_pdel", "T_b5B10", "T_b5B7",
    "GL", "GL_pdel", "GL_b3B10", "GL_CGf", "GLlog", "BIN_b5", "GP_pdel_I",
]


@pytest.mark.parametrize("name", SUBSET)
def test_jax_matches_exact(name, tmp_path, monkeypatch):
    outs = _run_both(name, tmp_path, monkeypatch)
    for m_exact, m_jax in zip(outs["exact"], outs["jax"]):
        np.testing.assert_allclose(m_jax, m_exact, rtol=0, atol=5e-9)


def test_weighted_fallback_matches_partials(monkeypatch):
    """Bootstrap via weighted recompute must equal partial-sum resummation."""
    rng = np.random.default_rng(7)
    P = rng.dirichlet([1.0, 1.0, 1.0], size=(200, 6)).astype(np.float64)
    pars = Params(in_geno="x", n_ind=6, n_sites=200, out="o", seed=11,
                  n_boot_rep=4, boot_block_size=10, indep_geno=True,
                  in_probs=True)
    n_trunc, maps = bt.site_maps(pars.seed, pars.n_boot_rep, pars.n_sites,
                                 pars.boot_block_size)
    mats_partial = list(dist.iter_replicates(pars, P, maps, n_trunc))
    monkeypatch.setattr(dist, "PARTIALS_BUDGET_BYTES", 0)
    mats_weighted = list(dist.iter_replicates(pars, P, maps, n_trunc))
    assert len(mats_partial) == 5
    for a, b in zip(mats_partial, mats_weighted):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_em_matches_exact_pairwise():
    """Direct EM-path check against the native per-site EM."""
    rng = np.random.default_rng(3)
    P = rng.dirichlet([0.7, 0.5, 0.7], size=(50, 4)).astype(np.float64)
    pars = Params(in_geno="x", n_ind=4, n_sites=50, out="o", seed=1,
                  in_probs=True, indep_geno=False, evol_model=0)
    mats = list(dist.iter_replicates(pars, P, [], 50))
    P_ind = exact_engine.to_ind_major(P)
    ref = exact_engine.pair_dists_exact(
        P_ind, pars.score, False, False, 0, 0, n_threads=1
    )
    np.testing.assert_allclose(mats[0], ref, rtol=0, atol=1e-9)


def test_f32_reasonable():
    """float32 (the device default) stays within documented tolerance of f64."""
    rng = np.random.default_rng(4)
    P = rng.dirichlet([1, 1, 1], size=(500, 8)).astype(np.float64)
    score = jnp.asarray(Params(in_geno="x").score)
    raw64, _ = dist.indep_suffstats(jnp.asarray(P), score, False)
    raw32, _ = dist.indep_suffstats(
        jnp.asarray(P, jnp.float32), jnp.asarray(score, jnp.float32), False
    )
    np.testing.assert_allclose(
        np.asarray(raw32), np.asarray(raw64), rtol=2e-5, atol=0
    )


def test_chunked_streaming_matches_resident(monkeypatch):
    """NGSDIST_DEVICE_BUDGET small enough to force site-chunk streaming:
    results must match the device-resident path exactly (same per-chunk
    contractions, plain sum across chunks)."""
    import numpy as np

    from ngsdist_jax.config import Params
    from ngsdist_jax.core import bootstrap as bt
    from ngsdist_jax.core import distance as dist

    rng = np.random.default_rng(21)
    S, N = 83, 6
    P = rng.dirichlet(np.ones(3), size=(S, N))
    P[rng.random((S, N)) < 0.15] = 1 / 3

    for indep, pdel in [(True, False), (True, True), (False, True)]:
        pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=5,
                      indep_geno=indep, pairwise_del=pdel, in_probs=True,
                      n_boot_rep=2, boot_block_size=7)
        n_trunc, maps = bt.site_maps(pars.seed, 2, S, 7)
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
        full = list(dist.iter_replicates(pars, P, maps, n_trunc))
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(20 * N * 3 * 8))  # ~20-site chunks
        chunked = list(dist.iter_replicates(pars, P, maps, n_trunc))
        assert len(full) == len(chunked) == 3
        for a, b in zip(full, chunked):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=f"{indep} {pdel}")


def test_em_overlap_stream_matches_resident(monkeypatch):
    """The EM overlap stream (distance.iter_replicates: f32 device
    backends chunk compute-bound EM runs into ~4 chunks so uploads hide
    under kernels) must reproduce the resident path.  CPU backends are
    excluded by the gate, so fake the backend probe; Pallas stays off
    (auto under CPU), which is exactly the XLA-formulation path the
    gate's chunks run through."""
    import jax
    import jax.numpy as jnp

    from ngsdist_jax.config import Params
    from ngsdist_jax.core import distance as dist

    rng = np.random.default_rng(33)
    S, N = 211, 8  # ragged: the 4-chunk split has a short tail
    monkeypatch.setattr(dist, "EM_OVERLAP_MIN_TRIPLES", 64)
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < 0.1] = 1 / 3
    pars = Params(in_geno="x", n_ind=N, n_sites=S, out="y", seed=5,
                  indep_geno=False, pairwise_del=True, in_probs=True)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        resident = list(dist.iter_replicates(pars, P, [], S))
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        # faked backend: keep the XLA scan (no card to compile for)
        monkeypatch.setattr(dist, "use_em_kernel", lambda dtype: False)
        overlap = list(dist.iter_replicates(pars, P, [], S))
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert len(resident) == len(overlap) == 1
    # f32 EM results are TILE-GROUPING sensitive at the convergence
    # plateau: exit checks run in chunks of EM steps over a batch, so
    # a lane grouped with slower neighbors takes extra (frozen-lane)
    # steps and stops elsewhere on the ~tole=1e-3 loglik plateau.
    # Resident f32 already sits 7e-5 from the f64 engine at this
    # shape; chunking moves results within the same class (a property
    # the budget-forced chunked path has always had).
    np.testing.assert_allclose(overlap[0], resident[0], rtol=0, atol=4e-4)


def test_em_zero_site_nan_parity(tmp_path, monkeypatch):
    """Empty-line text sites parse to (0,0,0) triples; on the EM path
    WITHOUT pairwise deletion the reference em2's NaN loglik poisons
    every pair at that site (ngsDist.cpp:348-349) — the whole matrix,
    since an empty line zeroes all individuals.  The engines' kernels
    exclude zero rows, so the poison is re-applied explicitly
    (distance._em_zero_rows; round-5 fuzz trial 302).  Pinned across
    the resident, partials-bootstrap, weighted-bootstrap and mesh
    paths, against the bit-exact oracle."""
    import gzip

    from ngsdist_jax import runner
    from ngsdist_jax.parallel import mesh as pm

    rng = np.random.default_rng(9)
    S, N = 60, 5
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = str(tmp_path / "z.geno.gz")
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            fh.write("" if s == 17 else
                     "\t".join(f"{x:.8f}" for x in gp[s].reshape(-1)))
            fh.write("\n")

    for pdel in (False, True):
        for reps, mesh in [(0, None), (3, None), (0, pm.make_mesh(n_devices=4)),
                           (3, pm.make_mesh(n_devices=4))]:
            base = dict(in_geno=path, in_probs=True, n_ind=N, n_sites=S,
                        seed=7, verbose=0, pairwise_del=pdel,
                        n_boot_rep=reps, boot_block_size=10)
            a = runner.run(Params(out=str(tmp_path / "a.dist"), **base),
                           engine="exact")
            b = runner.run(Params(out=str(tmp_path / "b.dist"), **base),
                           engine="jax", mesh=mesh)
            for ma, mb in zip(a, b):
                np.testing.assert_array_equal(np.isnan(ma), np.isnan(mb),
                                              err_msg=f"pdel={pdel} "
                                              f"reps={reps} mesh={mesh}")
                ok = ~np.isnan(ma)
                np.testing.assert_allclose(mb[ok], ma[ok], rtol=0,
                                           atol=1e-10)
    # the weighted-recompute bootstrap path (partials budget forced off)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(12 * N * 3 * 8))
    base = dict(in_geno=path, in_probs=True, n_ind=N, n_sites=S, seed=7,
                verbose=0, pairwise_del=False, n_boot_rep=2,
                boot_block_size=10)
    a = runner.run(Params(out=str(tmp_path / "a.dist"), **base),
                   engine="exact")
    b = runner.run(Params(out=str(tmp_path / "b.dist"), **base),
                   engine="jax")
    for ma, mb in zip(a, b):
        np.testing.assert_array_equal(np.isnan(ma), np.isnan(mb))
