"""Allele-frequency and haplotype-frequency estimators (batched JAX).

Batched JAX re-design of the reference's unlinked shared-library
estimators (/root/reference/shared/gen_func.cpp:936-1178, used by
sibling ngsTools):

  calc_HWE        gen_func.cpp:938-957  — HWE genotype priors with
                  inbreeding F (het prior zeroed at F == 1).
  est_maf         gen_func.cpp:974-1009 — per-site minor-allele-freq EM
                  from log-GLs; faithfully reproduces the reference's
                  accumulate-across-iterations num/den semantics (they
                  are never reset inside the do-loop) and its
                  |Δfreq| > EPSILON, <=100-iteration stop.
  haplo_freq      gen_func.cpp:1027-1119 — bcftools-derived two-site
                  haplotype-frequency EM (normal-space pair_freq_iter),
                  max-|Δ| < EPSILON stop, ITER_MAX=100.

est_maf_sites / haplo_freq run the whole batch of per-site (or
per-site-pair) problems as one vectorized `lax.while_loop` with
per-lane convergence freezing — the SIMD shape of the reference's
independent little EMs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

EPSILON = 1e-5   # gen_func.hpp:16
ITER_MAX = 100   # gen_func.hpp:18


def calc_hwe(maf, F):
    """[..., 3] HWE genotype frequencies with inbreeding coefficient F
    (calc_HWE, gen_func.cpp:938-957).  At F == 1 the heterozygote
    frequency is clamped to 1/INF rather than its algebraic 0."""
    maf = jnp.asarray(maf)
    p0 = (1 - maf) ** 2 + (1 - maf) * maf * F
    p1 = 2 * (1 - maf) * maf - 2 * (1 - maf) * maf * F
    p2 = maf ** 2 + (1 - maf) * maf * F
    p1 = jnp.where(jnp.asarray(F) == 1.0, 1e-15, p1)
    return jnp.stack([p0, p1, p2], axis=-1)


def _miss(gl_log: jnp.ndarray) -> jnp.ndarray:
    d01 = jnp.abs(gl_log[..., 0] - gl_log[..., 1])
    d12 = jnp.abs(gl_log[..., 1] - gl_log[..., 2])
    return (d01 < EPSILON) & (d12 < EPSILON)


def est_maf_sites(
    GL: jnp.ndarray,
    indF: Optional[jnp.ndarray] = None,
    ignore_miss_data: bool = True,
) -> jnp.ndarray:
    """Per-site minor-allele-frequency EM over a whole batch of sites.

    GL [S, N, 3] log-scale genotype likelihoods; indF None (uniform
    genotype prior, F treated as 0 in the allele-count expectations) or
    [N] per-individual inbreeding coefficients.  Returns [S] MAFs.
    """
    dtype = GL.dtype
    S = GL.shape[0]
    use = jnp.ones(GL.shape[:2], dtype)
    if ignore_miss_data:
        use = (~_miss(GL)).astype(dtype)
    F = None if indF is None else jnp.asarray(indF, dtype)[None, :]

    def posteriors(freq):
        if F is None:
            prior = jnp.zeros((1, 1, 3), dtype)
        else:
            prior = jnp.log(calc_hwe(freq[:, None], F))
        lp = GL + prior
        return jnp.exp(lp - jax.scipy.special.logsumexp(lp, axis=-1, keepdims=True))

    Fe = jnp.zeros((1, GL.shape[1]), dtype) if F is None else F

    def contrib(freq):
        pp = posteriors(freq)
        num = pp[..., 1] + pp[..., 2] * (2 - Fe)
        den = 2 * pp[..., 1] + (pp[..., 0] + pp[..., 2]) * (2 - Fe)
        return jnp.sum(num * use, axis=1), jnp.sum(den * use, axis=1)

    # Reference do-loop: num/den accumulate ACROSS iterations
    # (gen_func.cpp:976-1007 — they are initialized once, outside).
    def cond(state):
        it, _f, _n, _d, active = state
        return jnp.logical_and(it <= ITER_MAX, jnp.any(active > 0))

    def body(state):
        it, freq, num, den, active = state
        dn, dd = contrib(freq)
        num = num + jnp.where(active > 0, dn, 0.0)
        den = den + jnp.where(active > 0, dd, 0.0)
        new = num / den
        moved = jnp.abs(freq - new) > EPSILON
        freq = jnp.where(active > 0, new, freq)
        return it + 1, freq, num, den, active * moved.astype(dtype)

    # it starts at 0 with an inclusive bound: the reference's
    # post-increment guard (iters++ < 100) allows 101 loop bodies.
    init = (
        jnp.asarray(0, jnp.int32),
        jnp.full((S,), 0.01, dtype),
        jnp.zeros((S,), dtype),
        jnp.zeros((S,), dtype),
        jnp.ones((S,), dtype),
    )
    _, freq, _, _, _ = jax.lax.while_loop(cond, body, init)
    return freq


def est_maf(gl_log: jnp.ndarray, indF=None, ignore_miss_data: bool = True):
    """Single-site convenience wrapper (est_maf, gen_func.cpp:974-1009)."""
    return est_maf_sites(gl_log[None], indF, ignore_miss_data)[0]


# _G1/_G2: genotype of haplotype pair (h, k) at site 1 / site 2
# (gen_func.cpp:1074-1075).
_G1 = [[(h >> 1 & 1) + (k >> 1 & 1) for h in range(4)] for k in range(4)]
_G2 = [[(h & 1) + (k & 1) for h in range(4)] for k in range(4)]


def haplo_freq(
    gl1: jnp.ndarray,
    gl2: jnp.ndarray,
    maf1,
    maf2,
    ignore_miss_data: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-site haplotype-frequency EM (haplo_freq + pair_freq_iter,
    gen_func.cpp:1027-1119), batched over leading dims.

    gl1/gl2 [..., N, 3] NORMAL-space GLs for the two sites; maf1/maf2
    broadcastable to the leading dims.  Returns (hap_freq [..., 4],
    n_iter [...], n_used [...]).
    """
    dtype = gl1.dtype
    batch = gl1.shape[:-2]
    maf1 = jnp.broadcast_to(jnp.asarray(maf1, dtype), batch)
    maf2 = jnp.broadcast_to(jnp.asarray(maf2, dtype), batch)

    def miss_normal(gl):
        d01 = jnp.abs(gl[..., 0] - gl[..., 1])
        d12 = jnp.abs(gl[..., 1] - gl[..., 2])
        return (d01 < EPSILON) & (d12 < EPSILON)

    if ignore_miss_data:
        use = (~(miss_normal(gl1) | miss_normal(gl2))).astype(dtype)
    else:
        use = jnp.ones(gl1.shape[:-1], dtype)
    x = jnp.sum(use, axis=-1)  # individuals with data

    f0 = jnp.stack(
        [
            (1 - maf1) * (1 - maf2),
            (1 - maf1) * maf2,
            maf1 * (1 - maf2),
            maf1 * maf2,
        ],
        axis=-1,
    )

    # Per-(k,h) genotype lookups: p1[..., N, _G1[k][h]] etc.
    def em_step(f):
        # sum over (k,h) of f_k f_h p1[g1(k,h)] p2[g2(k,h)] per individual
        terms = []
        for k in range(4):
            row = []
            for h in range(4):
                t = (
                    f[..., k, None] * f[..., h, None]
                    * gl1[..., _G1[k][h]] * gl2[..., _G2[k][h]]
                )
                row.append(t)
            terms.append(row)
        ssum = sum(terms[k][h] for k in range(4) for h in range(4))  # [..., N]
        ff = []
        for k in range(4):
            tmp = sum(
                f[..., k, None] * f[..., h, None]
                * (gl1[..., _G1[h][k]] * gl2[..., _G2[h][k]]
                   + gl1[..., _G1[k][h]] * gl2[..., _G2[k][h]])
                for h in range(4)
            )
            ff.append(jnp.sum(use * tmp / ssum, axis=-1))
        ff = jnp.stack(ff, axis=-1) / (2 * x[..., None])
        return ff / jnp.sum(ff, axis=-1, keepdims=True)

    def cond(state):
        it, _f, active, _n = state
        return jnp.logical_and(it < ITER_MAX, jnp.any(active > 0))

    def body(state):
        it, f, active, n_iter = state
        fn = em_step(f)
        eps = jnp.max(jnp.abs(fn - f), axis=-1)
        f = jnp.where(active[..., None] > 0, fn, f)
        n_iter = n_iter + (active > 0)
        active = active * (eps >= EPSILON).astype(dtype)
        return it + 1, f, active, n_iter

    init = (
        jnp.asarray(0, jnp.int32),
        f0,
        jnp.ones(batch, dtype),
        jnp.zeros(batch, jnp.int32),
    )
    _, f, active, n_iter = jax.lax.while_loop(cond, body, init)
    # Reference returns the 0-based loop index at break (a lane converging
    # on its first step reports 0; a never-converging lane ITER_MAX).
    n_iter = jnp.where(active > 0, n_iter, jnp.maximum(n_iter - 1, 0))
    return f, n_iter, x
