"""Pairwise-EM distance kernel for NVIDIA Hopper (Pallas, Triton route).

The reference runs a tiny 9-cell EM per (pair, site) with an early
log-likelihood break (emOptim2.cpp:91-135, tole=0.001, maxIter=50 from
ngsDist.cpp:349).  Because each problem sees one site, the E step is an
elementwise reweighting: sfs_{t+1} ∝ sfs_t ⊙ W with W[g,h] = P1[g]·P2[h].
Hence sfs_t ∝ W^t elementwise, and the reference loglik after step t is
l_t = log S_{t+1} − log S_t with S_t = Σ_k W_k^t — so the convergence
test |l_t − l_{t−1}| < tole is a *ratio* test on successive sums, and
the whole EM needs no normalization at all if W is first scaled by its
max (the scale cancels in both sfs and the test; max entry 1 keeps
S_t ≥ 1, and f32 underflow of the losing cells only drives them to the
0 they converge to anyway).

W is RANK-1, so its power sums factorize per individual: S_k(a,b) =
tI_k[a]·tJ_k[b] with t_k = Σ_g p_g^k.  The power recurrences run on
[B] per-individual vectors; the [B, B] pair lanes only see a
one-multiply ratio test per step (see _em_site).

Kernel shape: one program per (individual-block pair, site split).
Each program reads its (i-block, j-block) from int32 tables, loops over
its site range inside the kernel and keeps the [B, B] raw/count sums in
registers; a site split writes a partial that the wrapper sums.  The
probabilities arrive plane-major ([3, S, N]), so each per-site load of
B individuals is one contiguous row.  Per-site weights (bootstrap
multiplicities, substitution-class masks) stream in as a [S] vector,
so every replicate shares one compiled shape.

Numerics vs the reference: identical update order, convergence rule
and iteration cap; differs only by the normalization arithmetic
(rounding-level).  The bit-exact contract is carried by the CPU engine
(core/exact.py); tests pin this kernel to the batched JAX EM
(core/em.py) at float64 in interpret mode.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

EM_TOLE = 0.001
EM_MAX_ITER = 50
EPSILON = 1e-5  # miss_data tolerance (gen_func.hpp:16)

# 7 | EM_MAX_ITER - 1, so exit checks every EM_CHUNK steps preserve the
# exact 49-step iteration cap of the reference (maxIter=50).
EM_CHUNK = 7

# Individual-block edge.  A [32, 32] pair tile is 8 f32 registers per
# thread per live array at 4 warps, so the loop state and both
# accumulators stay in registers; N=1024 gives 528 upper-triangle
# programs, four per SM on a 132-SM card.
DEFAULT_BLOCK = 32
NUM_WARPS = 4
NUM_STAGES = 1
# Programs to aim for: the site axis is split across programs until the
# grid reaches this many (small cohorts have few block pairs).
TARGET_PROGRAMS = 1024
MIN_SPLIT_SITES = 256


def choose_block(N: int) -> int:
    """Individual-block edge for an N-individual cohort: the smallest
    power of two >= N (at least 16), capped at DEFAULT_BLOCK.  The mesh
    block tables and the kernel wrapper must agree, so both call this."""
    return int(min(DEFAULT_BLOCK, max(16, pl.next_power_of_2(N))))


def choose_split(S: int, G: int) -> int:
    """Number of site ranges per block pair: enough programs to fill the
    card, but no range shorter than MIN_SPLIT_SITES."""
    want = -(-TARGET_PROGRAMS // max(1, G))
    return int(max(1, min(want, S // MIN_SPLIT_SITES)))


def upper_blocks(nb: int) -> Tuple[np.ndarray, np.ndarray]:
    iu = np.triu_indices(nb)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def _em_site(pi_raw, pj_raw, score, pairwise_del: bool):
    """EM-converged contributions for one site of one block pair.

    pi_raw, pj_raw: three [B] probability rows per side.  Returns
    (contrib, m), both [B, B]: score-weighted sfs sums and the lane
    validity mask.

    The reference's convergence ratio (S_{k+1}·S_{k−1})/S_k² becomes
    rI_k[a]·rJ_k[b] with r_k = t_{k+1}·t_{k−1}/t_k².  Normalizing each
    side by its max channel keeps t_k ≥ 1 (the per-lane scale (mi·mj)^k
    cancels exactly in the ratio).
    """
    dtype = pi_raw[0].dtype
    # A channel reconstructed on device as 1 - p0 - p1 can round a hair
    # below zero; the power sums need nonnegative channels (ln p < 0
    # would be NaN), so clamp them at the value they stand for.
    qi = [jnp.maximum(p, 0.0) for p in pi_raw]
    qj = [jnp.maximum(p, 0.0) for p in pj_raw]
    mi = jnp.maximum(jnp.maximum(qi[0], qi[1]), qi[2])  # [B]
    mj = jnp.maximum(jnp.maximum(qj[0], qj[1]), qj[2])
    dead_i = mi <= 0.0                               # padded / all-zero
    dead_j = mj <= 0.0
    si = jnp.where(dead_i, 1.0, mi)
    sj = jnp.where(dead_j, 1.0, mj)
    pi = [p / si for p in qi]
    pj = [p / sj for p in qj]
    dead = dead_i[:, None] | dead_j[None, :]          # [B, B]

    hi = jnp.asarray(np.exp(EM_TOLE), dtype)

    # Step invariant entering step k (k = 1, 2, …): PowI_g = pi_g^k,
    # tIm = t_{k−1}, tIc = t_k (same on the j side).  Each step advances
    # the per-individual powers one k ahead, forms the pair ratio, and
    # counts still-active steps into ksum: a lane first converging at
    # step k_c accumulates k_c − 1, so k* = 1 + ksum.  Never-converged
    # lanes run all EM_MAX_ITER − 1 steps and land on the cap.  Power
    # sums are log-convex in k (Cauchy–Schwarz), so every ratio is
    # ≥ 1 > exp(−tole): the band test needs only its upper edge.
    #
    # Early exit: ratios are nonnegative, so the tile's worst lane is
    # separable — max_{a,b} rI[a]·rJ[b] = (max rI)·(max rJ) — an O(B)
    # check per chunk (dead lanes are zeroed so they never poison it).
    def step(PI, tIm, tIc, PJ, tJm, tJc, ksum, active):
        PI = [p * q for p, q in zip(PI, pi)]          # pi^{k+1}
        PJ = [p * q for p, q in zip(PJ, pj)]
        tIn = PI[0] + PI[1] + PI[2]                   # t_{k+1}
        tJn = PJ[0] + PJ[1] + PJ[2]
        rI = jnp.where(dead_i, 0.0, tIn * tIm / (tIc * tIc))   # [B]
        rJ = jnp.where(dead_j, 0.0, tJn * tJm / (tJc * tJc))
        ratio = rI[:, None] * rJ[None, :]             # [B, B]
        active = jnp.where(ratio >= hi, active, 0.0)
        mprod = jnp.max(rI) * jnp.max(rJ)
        return PI, tIc, tIn, PJ, tJc, tJn, ksum + active, active, mprod

    n_steps = EM_MAX_ITER - 1
    assert n_steps % EM_CHUNK == 0

    def cond(state):
        return jnp.logical_and(state[0] < n_steps, state[-1] >= hi)

    def body(state):
        k, PI0, PI1, PI2, tIm, tIc, PJ0, PJ1, PJ2, tJm, tJc, ksum, active, _ = state
        PI, PJ = [PI0, PI1, PI2], [PJ0, PJ1, PJ2]
        for _ in range(EM_CHUNK):
            PI, tIm, tIc, PJ, tJm, tJc, ksum, active, mp = step(
                PI, tIm, tIc, PJ, tJm, tJc, ksum, active)
        return (k + EM_CHUNK, *PI, tIm, tIc, *PJ, tJm, tJc, ksum, active, mp)

    tI1 = pi[0] + pi[1] + pi[2]
    tJ1 = pj[0] + pj[1] + pj[2]
    active0 = jnp.where(dead, 0.0, 1.0).astype(dtype)
    state = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0, jnp.int32), *pi, jnp.full_like(tI1, 3.0), tI1,
         *pj, jnp.full_like(tJ1, 3.0), tJ1, jnp.zeros_like(active0),
         active0, jnp.asarray(np.inf, dtype)))
    kstar = 1.0 + state[-3]                           # [B, B]

    # sfs ∝ W^{k*} = (pi_g·pj_h)^{k*}: x_g = exp(k*·ln pi_g) per side
    # (ln 0 = −inf → exp(−inf·k*) = 0, the value those channels converge
    # to; the max channel is exactly 1), folded through the score as the
    # bilinear form Σ_g x_g·(Σ_h score[g,h]·y_h), normalized by
    # S_{k*} = (Σ x)(Σ y).
    li = [jnp.log(p)[:, None] for p in pi]
    lj = [jnp.log(p)[None, :] for p in pj]
    y = [jnp.exp(kstar * l) for l in lj]
    num = jnp.zeros_like(kstar)
    xsum = jnp.zeros_like(kstar)
    for g in range(3):
        x = jnp.exp(kstar * li[g])
        z = score[3 * g] * y[0] + score[3 * g + 1] * y[1] + score[3 * g + 2] * y[2]
        num = num + x * z
        xsum = xsum + x
    contrib = jnp.where(dead, 0.0, num / (xsum * (y[0] + y[1] + y[2])))

    # Padded individuals and sites are all-zero probability -> dead
    # lanes; excluding them reproduces the site mask.
    m = jnp.where(dead, 0.0, 1.0).astype(dtype)
    if pairwise_del:
        def valid(p):
            return ((jnp.abs(p[0] - p[1]) >= EPSILON)
                    | (jnp.abs(p[1] - p[2]) >= EPSILON))
        m = jnp.where(valid(pi_raw)[:, None] & valid(pj_raw)[None, :], m, 0.0)
    return contrib, m


def _em_kernel(ib_ref, jb_ref, p_ref, w_ref, score_ref, raw_ref, cnt_ref,
               *, block: int, site_chunk: int, pairwise_del: bool):
    g = pl.program_id(0)
    k = pl.program_id(1)
    i0 = pl.multiple_of(ib_ref[g] * block, block)
    j0 = pl.multiple_of(jb_ref[g] * block, block)
    score = [score_ref[c] for c in range(9)]
    dtype = raw_ref.dtype

    def site(s, carry):
        raw, cnt = carry
        pi = [p_ref[c, s, pl.ds(i0, block)] for c in range(3)]
        pj = [p_ref[c, s, pl.ds(j0, block)] for c in range(3)]
        contrib, m = _em_site(pi, pj, score, pairwise_del)
        # A site of weight w behaves exactly like w aliased copies of
        # itself (the reference's resampling, ngsDist.cpp:416-437).
        w = w_ref[s]
        return raw + w * (contrib * m), cnt + w * m

    s0 = k * site_chunk
    zero = jnp.zeros((block, block), dtype)
    raw, cnt = jax.lax.fori_loop(s0, s0 + site_chunk, site, (zero, zero))
    raw_ref[...] = raw
    cnt_ref[...] = cnt


@functools.partial(
    jax.jit,
    static_argnames=("pairwise_del", "block", "n_split", "interpret", "vma"),
)
def _em_blocks(P3, w, score, IB, JB, pairwise_del: bool, block: int,
               n_split: int, interpret: bool, vma=None):
    """[G, B, B] raw/count sums for the block pairs (IB, JB).

    P3: [3, S_pad, N_pad] plane-major probabilities, S_pad a multiple of
    n_split and N_pad of block; w: [S_pad]; score: [16] (first 9 used).
    """
    _, S_pad, _ = P3.shape
    G = IB.shape[0]
    dtype = P3.dtype
    kw = {} if vma is None else {"vma": frozenset(vma)}
    part = jax.ShapeDtypeStruct((n_split, G, block, block), dtype, **kw)
    out_spec = pl.BlockSpec((None, None, block, block),
                            lambda g, k: (k, g, 0, 0))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    kernel = functools.partial(_em_kernel, block=block,
                               site_chunk=S_pad // n_split,
                               pairwise_del=pairwise_del)
    raw, cnt = pl.pallas_call(
        kernel,
        out_shape=(part, part),
        grid=(G, n_split),
        in_specs=[whole] * 5,
        out_specs=(out_spec, out_spec),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="ngsdist_em",
    )(IB, JB, P3, w, score)
    return jnp.sum(raw, axis=0), jnp.sum(cnt, axis=0)


def em_raw_cnt(
    P: jnp.ndarray,
    score9,
    pairwise_del: bool,
    site_weights=None,
    *,
    block: Optional[int] = None,
    n_split: Optional[int] = None,
    interpret: bool = False,
    vma=None,
    blocks: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EM-path sufficient statistics via the kernel.

    P: [S, N, 3] normal-space probabilities.  Returns (raw, cnt) as
    [N, N] arrays whose strict upper triangle is valid (the lower
    triangle and diagonal are never read by callers).

    site_weights: any nonnegative per-site floats (bootstrap
    multiplicities, class masks or their products); may be a traced
    array (per-device weights under shard_map).

    blocks: optional (IB, JB) int32 [G] arrays naming the block pairs to
    compute (the 2-D mesh gives each device its own sublist).  They are
    runtime values, so per-device contents share one compiled kernel.
    Pad unequal lists with the lower-triangle block (1, 0): real
    compute, never read.

    vma: the varying mesh axes of the outputs when called inside
    shard_map.
    """
    S, N, _ = P.shape
    if block is None:
        block = choose_block(N)
    dtype = P.dtype
    N_pad = -(-N // block) * block
    nb = N_pad // block
    if blocks is not None:
        IB, JB = (jnp.asarray(b, jnp.int32) for b in blocks)
    else:
        IB, JB = (jnp.asarray(b) for b in upper_blocks(nb))
    G = int(IB.shape[0])
    if n_split is None:
        n_split = choose_split(S, G)
    S_pad = -(-S // n_split) * n_split
    P3 = jnp.pad(jnp.transpose(P, (2, 0, 1)),
                 ((0, 0), (0, S_pad - S), (0, N_pad - N)))
    if site_weights is None:
        w = jnp.ones((S,), dtype)
    else:
        w = jnp.asarray(site_weights, dtype).reshape(-1)
    w = jnp.pad(w, (0, S_pad - S))
    score = jnp.pad(jnp.asarray(score9, dtype).reshape(-1), (0, 7))
    raw_b, cnt_b = _em_blocks(P3, w, score, IB, JB, pairwise_del, block,
                              int(n_split), interpret,
                              None if vma is None else tuple(vma))

    def assemble(x):
        full = jnp.zeros((nb, nb, block, block), dtype).at[IB, JB].set(x)
        return full.transpose(0, 2, 1, 3).reshape(N_pad, N_pad)[:N, :N]

    return assemble(raw_b), assemble(cnt_b)
