"""Mesh-sharded distance engine: data parallelism over the site axis.

The reference's only parallelism is a single-node pthread pool with one
task per individual pair (/root/reference/ngsDist.cpp:197-269,
shared/threadpool.c).  The scale-out axis here is different: the
pair loop is already a tensor dimension (core/distance.py), so devices
shard the *site* axis of the [n_sites, n_ind, 3] probability tensor
across a 1-D `jax.sharding.Mesh` axis ``'sites'``.  Each device reduces
its local site shard to pairwise sufficient statistics (sum of expected
mismatches, valid-site counts, per-block partial sums) and the shards
are merged with `jax.lax.psum` (NCCL on GPUs), and only the small
[n_ind, n_ind] results ever cross devices.

`shard_map` (not plain jit-with-sharding) is deliberate for the EM path:
the per-(pair, site) EM is a `lax.while_loop` whose trip count depends on
local convergence; under shard_map each device iterates only as long as
*its* lanes need, with no cross-device lockstep.

Multi-host: the same code runs under `jax.distributed.initialize` (see
`distributed_init`); each host feeds its local site range via
`host_local_array_to_global_array` semantics (jax.make_array_from_
process_local_data), and the psum crosses hosts only once per run.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.distance import expand23, missing_mask
from ..utils.hostmem import (PAD23, pack23, parallel_cast_pad,
                             upload23_enabled)
from ..core.em import em_pair_site_contribs

AXIS = "sites"
PAIRS = "pairs"

# Per-shard site-tile element budget for the EM scan (tile*n_pairs*9).
EM_TILE_ELEM_BUDGET = 1 << 25


def _to_varying(x, axes=(AXIS,)):
    """Mark a constant as varying over the shard axes."""
    return jax.lax.pcast(x, tuple(axes), to="varying")


def make_mesh(devices=None, n_devices: Optional[int] = None,
              pairs: int = 1) -> Mesh:
    """Mesh over all (or the first n) addressable devices.

    pairs > 1 adds a second axis: devices factor into a
    (sites, pairs) grid and the engines additionally split the pair
    dimension (EM pair lists / output rows) across it — the TP analogue
    for very large cohorts, where the [N, N] / n_pairs tensors would
    otherwise replicate on every device (SURVEY.md §2.3 TP row).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    if pairs > 1:
        n = len(devices)
        if n % pairs:
            raise ValueError(f"{n} devices do not factor into pairs={pairs}")
        return Mesh(np.asarray(devices).reshape(n // pairs, pairs),
                    (AXIS, PAIRS))
    return Mesh(np.asarray(devices), (AXIS,))


def sites_size(mesh: Mesh) -> int:
    return dict(mesh.shape)[AXIS]


def pairs_size(mesh: Mesh) -> int:
    return dict(mesh.shape).get(PAIRS, 1)


def distributed_init(coordinator: Optional[str] = None, **kw) -> None:
    """Multi-host runtime bring-up (no-op when single-process)."""
    if jax.process_count() > 1 or coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator, **kw)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_sites(arr, mesh: Mesh):
    """Device-put an [S_pad, ...] array sharded along the site axis."""
    spec = P(AXIS, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


# Canonical 2-component upload pieces live beside the other host/device
# staging helpers: hostmem.pack23 (host pack + PAD23 sentinel marking
# of pad rows AND data-borne all-zero triples) and distance.expand23
# (sentinel-aware device expansion — elementwise, so NamedShardings
# propagate).  Re-exported here under the mesh-facing names.
expand23_sharded = expand23


def put_probs_sharded(P_host: np.ndarray, np_dtype, s_pad: int, mesh: Mesh,
                      may_zero: bool = True):
    """shard_sites of a [S, N, 3] host tensor, uploading only 2 of 3
    genotype components on f32 paths and reconstructing the third on
    device (utils/hostmem.upload23_enabled: triples are reader-
    normalized to sum 1, so the reconstruction is ~1e-7 relative —
    below the f32 engines' rounding).  may_zero=False skips pack23's
    all-zero-triple scan (binary-read inputs cannot contain one)."""
    if P_host.shape[-1] == 3 and upload23_enabled(np_dtype):
        return expand23_sharded(shard_sites(
            pack23(P_host, np_dtype, s_pad, may_zero=may_zero), mesh))
    return shard_sites(parallel_cast_pad(P_host, np_dtype, s_pad), mesh)


def global_site_vector(vals_fn, s_pad: int, mesh: Mesh, dtype):
    """[s_pad] site vector sharded over the mesh, assembled per process.

    vals_fn(start, stop) -> numpy slice for that site range.  Single
    process: plain device_put; multi-process: each process contributes
    its own range (jax.make_array_from_process_local_data)."""
    sharding = NamedSharding(mesh, P(AXIS))
    if jax.process_count() == 1:
        return jax.device_put(np.asarray(vals_fn(0, s_pad), dtype), sharding)
    from .multihost import host_site_range

    start, stop = host_site_range(s_pad, mesh)
    local = np.asarray(vals_fn(start, stop), dtype)
    return jax.make_array_from_process_local_data(sharding, local, (s_pad,))


def _divisor_at_most(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


# ------------------------------------------------------------------ #
# Independent-genotypes path                                          #
# ------------------------------------------------------------------ #


def _indep_local(Pl, ml, wl, score, pairwise_del: bool,
                 n_pairs_axis: int = 1):
    """Per-shard reduction.  Pl [Sl,N,3] local sites, ml [Sl] 1.0 for
    real sites, wl [Sl] site multiplicities.

    n_pairs_axis > 1: this device computes only its share of the
    output, a contiguous row slice — left operand sliced, right full —
    and the output rows shard over the 'pairs' axis (caller pre-pads N
    to a multiple of it)."""
    dtype = Pl.dtype
    if n_pairs_axis > 1:
        if pairwise_del:
            valid = (~missing_mask(Pl)).astype(dtype) * ml[:, None]
            Q = Pl * valid[..., None]
        else:
            valid = None
            Q = Pl
        Y = jnp.einsum("sjh,gh->sjg", Q, score.astype(dtype),
                   precision=jax.lax.Precision.HIGHEST)
        N = Q.shape[1]
        rows = -(-N // n_pairs_axis)
        r0 = jax.lax.axis_index(PAIRS) * rows
        Lp = jnp.pad(Q * wl[:, None, None],
                     ((0, 0), (0, rows * n_pairs_axis - N), (0, 0)))
        L = jax.lax.dynamic_slice_in_dim(Lp, r0, rows, axis=1)
        raw = jnp.einsum("sig,sjg->ij", L, Y, preferred_element_type=dtype,
                         precision=jax.lax.Precision.HIGHEST)
        raw = jax.lax.psum(raw, AXIS)
        cnt = None
        if pairwise_del:
            vp = jnp.pad(valid * wl[:, None],
                         ((0, 0), (0, rows * n_pairs_axis - N)))
            vrows = jax.lax.dynamic_slice_in_dim(vp, r0, rows, axis=1)
            cnt = jnp.einsum("si,sj->ij", vrows, valid,
                             preferred_element_type=dtype,
                             precision=jax.lax.Precision.HIGHEST)
            cnt = jax.lax.psum(cnt, AXIS)
        return raw, cnt
    if pairwise_del:
        valid = (~missing_mask(Pl)).astype(dtype) * ml[:, None]
        Q = Pl * valid[..., None]
    else:
        valid = None
        Q = Pl  # padded sites are all-zero -> contribute nothing
    Y = jnp.einsum("sjh,gh->sjg", Q, score.astype(dtype),
                   precision=jax.lax.Precision.HIGHEST)
    L = Q * wl[:, None, None]
    raw = jnp.einsum("sig,sjg->ij", L, Y, preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)
    raw = jax.lax.psum(raw, AXIS)
    cnt = None
    if pairwise_del:
        cnt = jnp.einsum("si,sj->ij", valid * wl[:, None], valid,
                         preferred_element_type=dtype,
                         precision=jax.lax.Precision.HIGHEST)
        cnt = jax.lax.psum(cnt, AXIS)
    return raw, cnt


@functools.partial(jax.jit, static_argnames=("pairwise_del", "mesh"))
def _indep_sharded(P_pad, mask, w, score, pairwise_del: bool, mesh: Mesh):
    p = pairs_size(mesh)
    fn = lambda Pl, ml, wl: _indep_local(Pl, ml, wl, score, pairwise_del,
                                         n_pairs_axis=p)
    if p > 1:
        out_specs = (P(PAIRS, None), P(PAIRS, None) if pairwise_del else None)
    else:
        out_specs = (P(), P()) if pairwise_del else (P(), None)
    raw, cnt = shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS), P(AXIS)),
        out_specs=out_specs,
    )(P_pad, mask, w)
    return raw, cnt


def _indep_blocks_local(Pl, ml, score, pairwise_del: bool, block_size: int):
    dtype = Pl.dtype
    Sl, N, _ = Pl.shape
    nb = Sl // block_size
    if pairwise_del:
        valid = (~missing_mask(Pl)).astype(dtype) * ml[:, None]
        Q = Pl * valid[..., None]
    else:
        valid = None
        Q = Pl
    Qb = Q.reshape(nb, block_size, N, 3)
    Yb = jnp.einsum("bsjh,gh->bsjg", Qb, score.astype(dtype),
                    precision=jax.lax.Precision.HIGHEST)
    B = jnp.einsum("bsig,bsjg->bij", Qb, Yb, preferred_element_type=dtype,
                   precision=jax.lax.Precision.HIGHEST)
    C = None
    if pairwise_del:
        vb = valid.reshape(nb, block_size, N)
        C = jnp.einsum("bsi,bsj->bij", vb, vb, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    return B, C


@functools.partial(
    jax.jit, static_argnames=("pairwise_del", "block_size", "mesh")
)
def _indep_blocks_sharded(P_pad, mask, score, pairwise_del, block_size, mesh):
    fn = lambda Pl, ml: _indep_blocks_local(Pl, ml, score, pairwise_del, block_size)
    out_specs = (P(AXIS, None, None), P(AXIS, None, None) if pairwise_del else None)
    return shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS)),
        out_specs=out_specs,
    )(P_pad, mask)


# ------------------------------------------------------------------ #
# EM path                                                             #
# ------------------------------------------------------------------ #


def _em_local(Pl, ml, wl, score9, I, J, pairwise_del: bool, tile: int,
              block_size: int, want_blocks: bool, use_kernel: bool = False,
              n_pairs_axis: int = 1, IBl=None, JBl=None,
              may_zero: bool = True):
    """Per-shard masked-EM reduction over local site tiles (mirrors
    core/distance._em_scan, but runs device-local under shard_map so the
    EM while_loop's trip count is local to this shard).  With use_kernel
    the EM kernel (ops/em_kernel.py) runs per device instead of the
    scan; on a 2-D mesh each pairs-coordinate computes only its own
    block sublist (IBl/JBl) and extracts its own pair slice."""
    dtype = Pl.dtype

    def zero_row_poison(raw_local):
        # Reference parity for data-borne all-zero triples on the
        # !pairwise_del EM path: poison the LOCAL pair partial where
        # either member has an included zero row in THIS shard — NaN
        # then rides the psum to every shard.  may_zero=False (binary
        # inputs, which cannot contain zero rows) skips the scan.
        if pairwise_del or not may_zero:
            return raw_local
        from ..core.distance import _em_poison_pairs, _em_zero_rows

        z = _em_zero_rows(Pl, (ml > 0) & (wl > 0))
        return _em_poison_pairs(raw_local, z, I, J)

    if use_kernel and not want_blocks:
        from ..ops import em_kernel

        # wl carries both the real-site mask and any bootstrap/class
        # weights; the kernel streams it as a per-site vector.
        if n_pairs_axis > 1:
            vma = (AXIS, PAIRS)
            blocks = (IBl.reshape(-1), JBl.reshape(-1))
        else:
            vma = (AXIS,)
            blocks = None
        raw_m, cnt_m = em_kernel.em_raw_cnt(Pl, score9, pairwise_del,
                                            site_weights=wl, vma=vma,
                                            blocks=blocks)
        raw = jax.lax.psum(zero_row_poison(raw_m[I, J]), AXIS)
        cnt = jax.lax.psum(cnt_m[I, J], AXIS)
        return raw, cnt
    Sl = Pl.shape[0]
    n_tiles = Sl // tile
    n_pairs = I.shape[0]
    bpt = tile // block_size if want_blocks else 1

    Pt = Pl.reshape(n_tiles, tile, Pl.shape[1], 3)
    mt = ml.reshape(n_tiles, tile)
    wt = wl.reshape(n_tiles, tile)

    def body(carry, xs):
        raw, cnt = carry
        Ptile, mtile, wtile = xs
        P1 = Ptile[:, I, :]
        P2 = Ptile[:, J, :]
        contrib = em_pair_site_contribs(P1, P2, score9)
        m = mtile[:, None]
        if pairwise_del:
            valid = (~missing_mask(Ptile)).astype(dtype)
            m = m * (valid[:, I] * valid[:, J])
        c_eff = contrib * m
        w = wtile[:, None]
        raw = raw + jnp.sum(c_eff * w, axis=0)
        cnt = cnt + jnp.sum(m * w, axis=0)
        ys = ()
        if want_blocks:
            seg = jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)[:, 0] // block_size
            Bt = jax.ops.segment_sum(c_eff, seg, num_segments=bpt)
            Ct = jax.ops.segment_sum(jnp.broadcast_to(m, c_eff.shape), seg,
                                     num_segments=bpt)
            ys = (Bt, Ct)
        return (raw, cnt), ys

    # The zero init is a constant but the scan outputs vary over the
    # shard axes (sites always; pairs too when the pair lists are
    # sharded); annotate so the carry types match under shard_map.
    axes = (AXIS, PAIRS) if n_pairs_axis > 1 else (AXIS,)
    zero = _to_varying(jnp.zeros((n_pairs,), dtype), axes)
    (raw, cnt), ys = jax.lax.scan(body, (zero, zero), (Pt, mt, wt))
    if not want_blocks:  # block partials stay clean (resummation
        raw = zero_row_poison(raw)  # poisons per sampled replicate)
    raw = jax.lax.psum(raw, AXIS)
    cnt = jax.lax.psum(cnt, AXIS)
    if want_blocks:
        B = ys[0].reshape(n_tiles * bpt, n_pairs)
        C = ys[1].reshape(n_tiles * bpt, n_pairs)
        return raw, cnt, B, C
    return raw, cnt


@functools.partial(
    jax.jit,
    static_argnames=("pairwise_del", "tile", "block_size", "want_blocks",
                     "mesh", "use_kernel", "may_zero"),
)
def _em_sharded(P_pad, mask, w, score9, I, J, pairwise_del, tile,
                block_size, want_blocks, mesh, use_kernel=False,
                IBt=None, JBt=None, may_zero=True):
    p = pairs_size(mesh)
    if p > 1 and use_kernel and not want_blocks:
        fn = lambda Pl, ml, wl, Il, Jl, IBl, JBl: _em_local(
            Pl, ml, wl, score9, Il, Jl, pairwise_del, tile, block_size,
            want_blocks, use_kernel, n_pairs_axis=p, IBl=IBl, JBl=JBl,
            may_zero=may_zero,
        )
        return shard_map(
            fn, mesh=mesh,
            in_specs=(P(AXIS, None, None), P(AXIS), P(AXIS), P(PAIRS),
                      P(PAIRS), P(PAIRS, None), P(PAIRS, None)),
            out_specs=(P(PAIRS), P(PAIRS)),
        )(P_pad, mask, w, I, J, IBt, JBt)
    fn = lambda Pl, ml, wl, Il, Jl: _em_local(
        Pl, ml, wl, score9, Il, Jl, pairwise_del, tile, block_size,
        want_blocks, use_kernel, n_pairs_axis=p, may_zero=may_zero,
    )
    # With a pairs axis the pair lists are sharded across it: each
    # device converges only its own pair slice.
    pair_spec = P(PAIRS) if p > 1 else P()
    out_pair = P(PAIRS) if p > 1 else P()
    if want_blocks:
        block_spec = P(AXIS, PAIRS) if p > 1 else P(AXIS, None)
        out_specs = (out_pair, out_pair, block_spec, block_spec)
    else:
        out_specs = (out_pair, out_pair)
    return shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS), P(AXIS), pair_spec, pair_spec),
        out_specs=out_specs,
    )(P_pad, mask, w, I, J)


@functools.lru_cache(maxsize=8)
def _pair_block_tables_cached(N: int, p: int, block: int):
    """Device-resident [p, G_max] block tables for an N-individual
    cohort: pure functions of (N, p, block), rebuilt per replicate and
    per stream round without this cache (p sort-based unique passes
    over ~n_pairs rows plus a transfer, each call)."""
    from ..core.distance import _pair_indices

    I, J = _pair_indices(N)
    n_pairs = len(I)
    n_pad = -(-n_pairs // p) * p
    if n_pad > n_pairs:
        I = np.concatenate([I, np.full(n_pad - n_pairs, I[-1], np.int32)])
        J = np.concatenate([J, np.full(n_pad - n_pairs, J[-1], np.int32)])
    IBt, JBt = _pair_block_tables(I, J, p, block)
    return jnp.asarray(IBt), jnp.asarray(JBt)


def _pair_block_tables(I: np.ndarray, J: np.ndarray, p: int,
                       block: int) -> Tuple[np.ndarray, np.ndarray]:
    """[p, G_max] per-pairs-device upper-tri block sublists for the EM
    kernel: device d computes only the block x block tiles containing its
    contiguous pair slice (~1/p of the upper triangle).  Rows pad with
    the lower-triangle block (1, 0) — real compute, never read, and
    distinct from every valid (upper) entry; padding only arises when
    the grid has >= 2 block rows."""
    per = len(I) // p
    sets = []
    for d in range(p):
        ib = I[d * per:(d + 1) * per] // block
        jb = J[d * per:(d + 1) * per] // block
        sets.append(np.unique(np.stack([ib, jb], axis=1), axis=0))
    G = max(len(s) for s in sets)
    IBt = np.full((p, G), 1, np.int32)
    JBt = np.zeros((p, G), np.int32)
    for d, s in enumerate(sets):
        IBt[d, :len(s)] = s[:, 0]
        JBt[d, :len(s)] = s[:, 1]
    return IBt, JBt


# ------------------------------------------------------------------ #
# Extended evolutionary models: per-pair base frequencies             #
# ------------------------------------------------------------------ #


@functools.partial(jax.jit, static_argnames=("pairwise_del", "mesh"))
def _pair_pi_sharded(Pp, A1, A2, w, pairwise_del: bool, mesh: Mesh):
    """Sharded expected-base-count contraction for models 4-6
    (core/submodels.expected_base_counts + the pair_pi accumulators in
    core/distance._iter_replicates_extended, computed device-side so
    the mesh path never materializes the [S, N, 4] count tensor on
    host).

    Pp [S_pad, N, 3] sharded sites; A1/A2 [S_pad, 4] one-hot allele
    rows (all-zero on invalid/padded sites — keeps padding inert even
    though d1 = 2 there); w [S_pad] classifiable-site weights.  Returns
    U [N, N, 4] (pairwise_del: weighted i-side counts against valid
    j-sides, to be symmetrized by the caller) or c [N, 4].
    """
    p = pairs_size(mesh)

    def fn(Pl, a1l, a2l, wl):
        dtype = Pl.dtype
        d2 = Pl[..., 1] + 2.0 * Pl[..., 2]     # expected allele2 dosage
        d1 = 2.0 - d2
        bc = (d1[:, :, None] * a1l[:, None, :]
              + d2[:, :, None] * a2l[:, None, :])  # [Sl, N, 4]
        if pairwise_del:
            valid = (~missing_mask(Pl)).astype(dtype)
            vw = valid * wl[:, None]
            L = bc * vw[:, :, None]
            if p > 1:  # rows-slice of the i axis, like _indep_local
                N = L.shape[1]
                rows = -(-N // p)
                r0 = jax.lax.axis_index(PAIRS) * rows
                Lp = jnp.pad(L, ((0, 0), (0, rows * p - N), (0, 0)))
                L = jax.lax.dynamic_slice_in_dim(Lp, r0, rows, axis=1)
            U = jnp.einsum("six,sj->ijx", L, valid,
                           preferred_element_type=dtype,
                           precision=jax.lax.Precision.HIGHEST)
            return jax.lax.psum(U, AXIS)
        c = jnp.einsum("s,six->ix", wl, bc, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
        c = jax.lax.psum(c, AXIS)
        if p > 1:
            N = c.shape[0]
            rows = -(-N // p)
            r0 = jax.lax.axis_index(PAIRS) * rows
            c = jax.lax.dynamic_slice_in_dim(
                jnp.pad(c, ((0, rows * p - N), (0, 0))), r0, rows, axis=0)
        return c

    if p > 1:
        out_specs = P(PAIRS, None, None) if pairwise_del else P(PAIRS, None)
    else:
        out_specs = P()
    return shard_map(
        fn, mesh=mesh,
        in_specs=(P(AXIS, None, None), P(AXIS, None), P(AXIS, None), P(AXIS)),
        out_specs=out_specs,
    )(Pp, A1, A2, w)


def allele_onehots(a1: np.ndarray, a2: np.ndarray, np_dtype=np.float64):
    """[S, 4] one-hot allele rows, all-zero on invalid sites — the
    host-side inputs to the sharded base-count contraction."""
    ok = (a1 >= 0) & (a2 >= 0)
    A1h = np.where(ok[:, None], np.eye(4, dtype=np_dtype)[np.clip(a1, 0, 3)], 0)
    A2h = np.where(ok[:, None], np.eye(4, dtype=np_dtype)[np.clip(a2, 0, 3)], 0)
    return A1h, A2h


def pair_pi_counts(Pp, A1, A2, w, mesh: Mesh, *, pairwise_del: bool) -> np.ndarray:
    """Unnormalized expected-base-count accumulators for one (round of
    a) sharded array: U [N, N, 4] (pairwise_del) or c [N, 4], float64.
    Additive over site rounds; normalize once with normalize_pair_pi."""
    out = np.asarray(_pair_pi_sharded(Pp, A1, A2, w, pairwise_del, mesh),
                     np.float64)
    N = int(Pp.shape[1])
    return out[:N]  # trim pairs-axis row padding (no-op on 1-D meshes)


def normalize_pair_pi(acc: np.ndarray, pairwise_del: bool) -> np.ndarray:
    """[N, N, 4] per-pair base frequencies from the accumulated counts."""
    if pairwise_del:
        tot = acc + np.transpose(acc, (1, 0, 2))
    else:
        tot = acc[:, None, :] + acc[None, :, :]
    denom = np.sum(tot, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        return tot / denom


def sharded_pair_pi(
    P_host,
    a1: np.ndarray,
    a2: np.ndarray,
    w_ok: np.ndarray,
    mesh: Mesh,
    *,
    pairwise_del: bool,
    dtype=None,
    n_sites: Optional[int] = None,
    may_zero: bool = True,
):
    """[N, N, 4] per-pair base frequencies over the mesh (models 4-6).

    P_host: numpy [S, N, 3] or a prebuilt padded sharded jax.Array
    (multi-host path; pass n_sites).  a1/a2: [S] allele codes
    (core/submodels.encode_alleles).  w_ok: [S] classifiable-site
    weights (class mask x bootstrap multiplicities).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    S, N = int(P_host.shape[0]), int(P_host.shape[1])
    if n_sites is not None:
        S = int(n_sites)
    elif isinstance(P_host, jax.Array):
        raise ValueError("prebuilt sharded arrays require explicit n_sites")
    n_dev = sites_size(mesh)

    if isinstance(P_host, jax.Array):
        s_pad = int(P_host.shape[0])
        Pp = P_host
    else:
        s_pad = _plan_padding(S, n_dev, 1)
        Pp = put_probs_sharded(P_host, np_dtype, s_pad, mesh,
                               may_zero=may_zero)

    A1h, A2h = allele_onehots(a1, a2, np_dtype)

    def slice2(arr):
        def fn(start, stop):
            out = np.zeros((stop - start, 4), np_dtype)
            hi = min(stop, S)
            if hi > start:
                out[: hi - start] = arr[start:hi]
            return out
        return fn

    spec2 = NamedSharding(mesh, P(AXIS, None))
    if jax.process_count() == 1:
        A1 = jax.device_put(slice2(A1h)(0, s_pad), spec2)
        A2 = jax.device_put(slice2(A2h)(0, s_pad), spec2)
    else:
        from .multihost import host_site_range

        start, stop = host_site_range(s_pad, mesh)
        A1 = jax.make_array_from_process_local_data(
            spec2, slice2(A1h)(start, stop), (s_pad, 4))
        A2 = jax.make_array_from_process_local_data(
            spec2, slice2(A2h)(start, stop), (s_pad, 4))

    def w_fn(start, stop):
        out = np.zeros((stop - start,), np_dtype)
        hi = min(stop, len(w_ok))
        if hi > start:
            out[: hi - start] = w_ok[start:hi]
        return out

    w = global_site_vector(w_fn, s_pad, mesh, np_dtype)

    acc = pair_pi_counts(Pp, A1, A2, w, mesh, pairwise_del=pairwise_del)
    return normalize_pair_pi(acc, pairwise_del)


# ------------------------------------------------------------------ #
# Bootstrap resummation over sharded block partials                   #
# ------------------------------------------------------------------ #


@functools.partial(jax.jit, static_argnames=("mesh",))
def resum_blocks(M, B, mesh: Mesh):
    """Weighted resummation of per-block partial sums.

    M [n_reps, n_blocks_pad] multiplicities, B [n_blocks_pad, ...] block
    partials sharded on the leading axis.  Returns [n_reps, ...]
    replicated — each device contracts its local blocks, then psum.
    """
    sub = "bp->rp" if B.ndim == 2 else "bij->rij"

    def fn(Ml, Bl):
        out = jnp.einsum("rb," + sub, Ml, Bl, preferred_element_type=B.dtype,
                         precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(out, AXIS)

    in_specs = (P(None, AXIS), P(AXIS, *([None] * (B.ndim - 1))))
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=P())(M, B)


# ------------------------------------------------------------------ #
# Host-facing API                                                     #
# ------------------------------------------------------------------ #


def _pair_indices(n_ind: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    iu = np.triu_indices(n_ind, k=1)
    return jnp.asarray(iu[0], jnp.int32), jnp.asarray(iu[1], jnp.int32)


def _plan_padding(S: int, n_dev: int, granule: int) -> int:
    """Padded global site count: per-shard length a multiple of granule."""
    s_loc = _round_up(_round_up(S, n_dev) // n_dev, granule)
    return s_loc * n_dev


def _em_tile(n_pairs: int, s_loc: int, block_size: int) -> int:
    tile = max(1, EM_TILE_ELEM_BUDGET // max(1, n_pairs * 9))
    tile = max(block_size, (tile // block_size) * block_size)
    return min(tile, s_loc) if s_loc else tile


def sharded_suffstats(
    P_host: np.ndarray,
    score: np.ndarray,
    mesh: Mesh,
    *,
    indep: bool,
    pairwise_del: bool,
    site_weights: Optional[np.ndarray] = None,
    n_blocks: Optional[int] = None,
    block_size: int = 1,
    dtype=None,
    n_sites: Optional[int] = None,
    may_zero: bool = True,
):
    """Sufficient statistics over the mesh.

    Returns (raw, cnt, B, C): raw/cnt replicated [N,N] (indep) or
    [n_pairs] (EM); when n_blocks is given, additionally computes
    per-block partials B/C kept *sharded and padded* on their block axis
    (rows >= n_blocks cover truncation-remainder/padding sites and are
    ignored by `bootstrap_replicates` via zero multiplicities); in that
    case raw/cnt are None for the indep path (compute full-data stats
    with a separate call) and the full-data stats for the EM path.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    S, N, _ = P_host.shape
    # Prebuilt global arrays are PADDED, so their leading dim is NOT the
    # real site count — the caller must pass n_sites so the site mask
    # ends at the data, not at the padding.
    if n_sites is not None:
        S = int(n_sites)
    elif isinstance(P_host, jax.Array):
        raise ValueError("prebuilt sharded arrays require explicit n_sites")
    n_dev = sites_size(mesh)
    p = pairs_size(mesh)
    want_blocks = n_blocks is not None
    if want_blocks and p > 1:
        raise ValueError(
            "block partials are 1-D-mesh only; 2-D (pairs) meshes take the "
            "weighted-recompute bootstrap path"
        )
    I, J = _pair_indices(N)
    n_pairs = int(I.shape[0])
    n_pairs_pad = -(-n_pairs // p) * p
    if n_pairs_pad > n_pairs:
        # duplicate the LAST real pair to keep the per-device slice
        # shape equal (outputs are trimmed below): its block is already
        # in the last device's sublist, so padding adds no extra block
        # to the kernel path (dummy (0,0) pairs used to drag block
        # (0,0) into that device's table)
        I = jnp.concatenate([I, jnp.full((n_pairs_pad - n_pairs,), I[-1])])
        J = jnp.concatenate([J, jnp.full((n_pairs_pad - n_pairs,), J[-1])])

    prebuilt = isinstance(P_host, jax.Array)

    if prebuilt:
        # Caller supplied the padded, sharded global array (multi-host
        # path: parallel/multihost.load_global_probs).
        s_pad = int(P_host.shape[0])
        if s_pad % n_dev:
            raise ValueError("prebuilt array not evenly sharded over devices")
        s_loc = s_pad // n_dev
        if indep:
            if want_blocks and s_loc % block_size:
                raise ValueError("prebuilt shard length not a block multiple")
            tile = None
        else:
            base = block_size if want_blocks else 1
            if s_loc % base:
                raise ValueError("prebuilt shard length not a block multiple")
            # tile = base * (divisor of s_loc/base), capped near the
            # preferred tile: divides s_loc AND is a block multiple.
            pref = _em_tile(n_pairs_pad // p, s_loc, block_size)
            tile = base * _divisor_at_most(s_loc // base, max(1, pref // base))
        Pp = P_host
    else:
        if indep:
            granule = block_size if want_blocks else 1
            tile = None
        else:
            s_loc_est = _round_up(S, n_dev) // n_dev
            tile = _em_tile(n_pairs_pad // p, _round_up(s_loc_est, block_size),
                            block_size)
            granule = tile
        s_pad = _plan_padding(S, n_dev, granule)
        Pp = put_probs_sharded(P_host, np_dtype, s_pad, mesh,
                               may_zero=may_zero)

    def mask_fn(start, stop):
        out = np.zeros((stop - start,), np_dtype)
        hi = min(stop, S)
        if hi > start:
            out[: hi - start] = 1.0
        return out

    mask = global_site_vector(mask_fn, s_pad, mesh, np_dtype)
    if site_weights is None:
        w = mask
    elif isinstance(site_weights, jax.Array) and site_weights.ndim == 1:
        # Prebuilt sharded weight vector (SiteStream.round_cols) — must
        # already be padded to the sharded site axis.
        if int(site_weights.shape[0]) != s_pad:
            raise ValueError("prebuilt site_weights length != padded sites")
        w = site_weights
    else:
        sw = np.asarray(site_weights)

        def w_fn(start, stop):
            out = np.zeros((stop - start,), np_dtype)
            hi = min(stop, len(sw))
            if hi > start:
                out[: hi - start] = sw[start:hi]
            return out

        w = global_site_vector(w_fn, s_pad, mesh, np_dtype)
    score_d = jnp.asarray(score, dtype)
    score9 = score_d.reshape(-1)

    if indep:
        if want_blocks:
            B, C = _indep_blocks_sharded(Pp, mask, score_d, pairwise_del,
                                         block_size, mesh)
            return None, None, B, C
        raw, cnt = _indep_sharded(Pp, mask, w, score_d, pairwise_del, mesh)
        if p > 1:  # rows were padded to a multiple of the pairs axis
            raw = raw[:N]
            cnt = None if cnt is None else cnt[:N]
        return raw, cnt, None, None

    from ..core.distance import use_em_kernel

    # The weighted kernel serves bootstrap replicates too; only the
    # block-partials variant needs the scan formulation.  On a 2-D mesh
    # each pairs-coordinate runs the kernel over its own block sublist
    # (the tables are runtime values: one compiled kernel).
    em_kernel = not want_blocks and use_em_kernel(dtype)
    IBt = JBt = None
    if em_kernel and p > 1:
        from ..ops.em_kernel import choose_block

        IBt, JBt = _pair_block_tables_cached(N, p, choose_block(N))
    out = _em_sharded(Pp, mask, w, score9, I, J, pairwise_del, tile,
                      block_size if want_blocks else 1, want_blocks, mesh,
                      use_kernel=em_kernel, IBt=IBt, JBt=JBt,
                      may_zero=may_zero)
    if want_blocks:
        return out
    raw, cnt = out
    if n_pairs_pad > n_pairs:
        raw = raw[:n_pairs]
        cnt = cnt[:n_pairs]
    return raw, cnt, None, None


def concat_block_rounds(parts, mesh: Mesh):
    """Concatenate per-round block partials PER DEVICE along the block
    axis (1-D meshes only).  A global concatenate would interleave
    rounds across devices; per-device concatenation keeps each device's
    rows in local round order.  NOTE: the result is DEVICE-MAJOR with
    any per-round pad rows IN PLACE — when the round chunk does not
    divide the shard length, pad rows sit inside each device's range,
    so positional multiplicity vectors are WRONG.  Consumers must
    permute their resummation weights by the true row->block map
    (core.distance._stream_block_rows; round-5 trial-507 bug)."""
    if len(parts) == 1:
        return parts[0]
    spec = P(AXIS, *([None] * (parts[0].ndim - 1)))
    fn = lambda *ls: jnp.concatenate(ls, axis=0)
    return shard_map(fn, mesh=mesh, in_specs=(spec,) * len(parts),
                     out_specs=spec)(*parts)


def bootstrap_replicates(
    table: np.ndarray,
    B,
    C,
    n_blocks: int,
    mesh: Mesh,
):
    """Resum sharded block partials into per-replicate stats.

    table: [n_reps, n_blocks] source-block index table.  B (and C) as
    returned by sharded_suffstats *before* the [:n_blocks] slice is
    re-padded here to match the sharded block axis.
    """
    from ..core.bootstrap import block_multiplicity

    n_blocks_pad = int(B.shape[0]) if B.shape[0] >= n_blocks else n_blocks
    M = block_multiplicity(table, n_blocks)
    if n_blocks_pad > n_blocks:
        M = np.concatenate(
            [M, np.zeros((M.shape[0], n_blocks_pad - n_blocks))], axis=1
        )
    M_d = jnp.asarray(M, B.dtype)
    raw_r = resum_blocks(M_d, B, mesh)
    cnt_r = None if C is None else resum_blocks(M_d, C, mesh)
    return raw_r, cnt_r
