"""Batched HMM engine: forward / backward / Viterbi with
distance-dependent transitions and GL-based emissions.

Batched JAX re-design of the reference HMM (/root/reference/shared/
HMM.cpp:1-236, an unlinked shared-library component used by sibling
ngsTools such as ngsF-HMM): the per-site loops become `lax.scan` in log
space, and every function is jit/vmap-compatible so whole cohorts of
chains (one per individual) run batched on device.

Model semantics (calc_trans, HMM.cpp:130-139): between adjacent sites at
distance d the chain stays coancestry-identical with probability
e^{-alpha*d} and otherwise redraws the state from the stationary
proportions q:  T_d[k,l] = (1-e^{-alpha*d})*q[l] + [k==l]*e^{-alpha*d}.

Emissions (calc_emission, HMM.cpp:144-156): log P(GL | state) =
logsumexp_g(gl[g] + log HWE(maf, F_state)[g]).

Array convention (matches the reference): the chain starts in a
*virtual* start row distributed as q with no emission (Fw[0] = log q,
HMM.cpp:9-10); every observation s = 0..S-1 then gets a transition
built from pos_dist[s] (the distance entering that site,
io/readers.read_pos_dist; inf at chromosome changes -> the transition
resets to the stationary distribution, exactly e^{-alpha*inf} = 0)
followed by its emission e_prob[s].
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .freqs import calc_hwe


def transition_matrices(q_prop: jnp.ndarray, alpha, pos_dist: jnp.ndarray) -> jnp.ndarray:
    """[S, K, K] log transition matrices for each inter-site distance.

    q_prop [K] stationary state proportions; pos_dist [S] distances
    entering each observation."""
    K = q_prop.shape[0]
    stay = jnp.exp(-alpha * pos_dist)[:, None, None]          # [S,1,1]
    T = (1.0 - stay) * q_prop[None, None, :]
    T = T + stay * jnp.eye(K, dtype=q_prop.dtype)[None]
    return jnp.log(T)


def calc_emission(gl: jnp.ndarray, maf, F) -> jnp.ndarray:
    """log P(GL | maf, inbreeding F): logsumexp over genotypes of
    log-GL + log HWE prior (calc_emission, HMM.cpp:144-156).  gl is
    log-scale [..., 3]."""
    prior = jnp.log(calc_hwe(maf, F))
    return jax.scipy.special.logsumexp(gl + prior, axis=-1)


def calc_emission_two_mafs(gl: jnp.ndarray, maf1, maf2) -> jnp.ndarray:
    """Emission with independent allele frequencies per haplotype
    (calc_emission overload, HMM.cpp:158-170)."""
    prior = jnp.log(
        jnp.stack(
            [
                (1 - maf1) * (1 - maf2),
                (1 - maf1) * maf2 + maf1 * (1 - maf2),
                maf1 * maf2,
            ],
            axis=-1,
        )
    )
    return jax.scipy.special.logsumexp(gl + prior, axis=-1)


def forward(
    q_prop: jnp.ndarray, alpha, e_prob: jnp.ndarray, pos_dist: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward recursion.  e_prob [S, K] log emissions, pos_dist [S].

    Returns (Fw [S, K] log forward messages, loglik scalar) — the
    reference's forward() (HMM.cpp:6-27) with its site-0 init folded in.
    """
    logT = transition_matrices(q_prop, alpha, pos_dist)

    def step(f_prev, xs):
        lT, e = xs
        f = jax.scipy.special.logsumexp(f_prev[:, None] + lT, axis=0) + e
        return f, f

    _, Fw = jax.lax.scan(step, jnp.log(q_prop), (logT, e_prob))
    return Fw, jax.scipy.special.logsumexp(Fw[-1])


def backward(
    q_prop: jnp.ndarray, alpha, e_prob: jnp.ndarray, pos_dist: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Backward recursion (HMM.cpp:32-60).

    Returns (Bw [S, K] — Bw[s][k] is the log probability of observations
    s+1.. given state k at observation s — and the loglik computed from
    the virtual start row)."""
    logT = transition_matrices(q_prop, alpha, pos_dist)
    bS = jnp.zeros_like(e_prob[-1])

    def step(b_next, xs):
        lT, e = xs
        b = jax.scipy.special.logsumexp(lT + (e + b_next)[None, :], axis=1)
        return b, b

    # steps for observations S-1 .. 1 produce Bw rows S-2 .. 0
    _, Bw_rest = jax.lax.scan(
        step, bS, (logT[1:], e_prob[1:]), reverse=True
    )
    Bw = jnp.concatenate([Bw_rest, bS[None]], axis=0)
    # virtual start row: b_start[k] = logsum_l T_0[k,l] + e[0,l] + Bw[0,l]
    b_start = jax.scipy.special.logsumexp(
        logT[0] + (e_prob[0] + Bw[0])[None, :], axis=1
    )
    loglik = jax.scipy.special.logsumexp(jnp.log(q_prop) + b_start)
    return Bw, loglik


def posterior_decode(
    q_prop: jnp.ndarray, alpha, e_prob: jnp.ndarray, pos_dist: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[S, K] log posterior state probabilities and the loglik."""
    Fw, ll = forward(q_prop, alpha, e_prob, pos_dist)
    Bw, _ = backward(q_prop, alpha, e_prob, pos_dist)
    return Fw + Bw - ll, ll


def viterbi(
    q_prop: jnp.ndarray, alpha, e_prob: jnp.ndarray, pos_dist: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Most probable state path (HMM.cpp:102-125).

    Returns (path [S] int32, best log score)."""
    logT = transition_matrices(q_prop, alpha, pos_dist)

    def step(v_prev, xs):
        lT, e = xs
        scores = v_prev[:, None] + lT            # [K_from, K_to]
        back = jnp.argmax(scores, axis=0)
        v = jnp.max(scores, axis=0) + e
        return v, (v, back)

    v_last, (_, backs) = jax.lax.scan(
        step, jnp.log(q_prop), (logT, e_prob)
    )
    last = jnp.argmax(v_last)

    def trace(state, back):
        return back[state], state

    # backs[0] points into the virtual start row; trace only through the
    # S-1 inter-observation steps (emitting states for observations
    # 1..S-1, ending with `last`); the final carry is observation 0.
    first, rest = jax.lax.scan(trace, last, backs[1:], reverse=True)
    path = jnp.concatenate([first[None].astype(jnp.int32), rest.astype(jnp.int32)])
    return path, jnp.max(v_last)


def joint_geno_prob(hap_freq: jnp.ndarray, F: int) -> jnp.ndarray:
    """[3, 3] joint genotype probability table P(g_prev, g_cur) from the
    four haplotype frequencies [P_BA, P_Ba, P_bA, P_ba]
    (joint_geno_prob, HMM.cpp:205-236).  F is the shared inbreeding
    level of both positions: 0 = outbred (haplotypes pair independently),
    1 = fully inbred (the two haplotypes are identical, so heterozygous
    combinations are impossible)."""
    f0, f1, f2, f3 = (hap_freq[..., k] for k in range(4))
    if F == 0:
        rows = [
            [f0 ** 2, 2 * f0 * f1, f1 ** 2],
            [2 * f0 * f2, 2 * (f0 * f3 + f1 * f2), 2 * f1 * f3],
            [f2 ** 2, 2 * f2 * f3, f3 ** 2],
        ]
    else:
        z = jnp.zeros_like(f0)
        rows = [[f0, z, f1], [z, z, z], [f2, z, f3]]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def calc_emission_ld(
    hap_freq: jnp.ndarray,
    gl_prev: jnp.ndarray,
    gl_cur: jnp.ndarray,
    maf_prev,
    F: int,
) -> jnp.ndarray:
    """LD-aware emission: log P(GL_cur | GL_prev, haplotype freqs, F)
    (calc_emissionLD's live branch, HMM.cpp:175-203: the joint
    probability under the two-site haplotype model divided by the
    previous site's single-site emission).

    gl_prev/gl_cur are log-scale [..., 3]; hap_freq [..., 4]."""
    s_p = jnp.exp(gl_prev)
    s_c = jnp.exp(gl_cur)
    J = joint_geno_prob(hap_freq, F)                   # [..., 3, 3]
    joint = jnp.einsum("...pc,...p,...c->...", J, s_p, s_c)
    return jnp.log(joint) - calc_emission(gl_prev, maf_prev, F)
