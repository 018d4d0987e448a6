"""Batched distance engine (JAX/XLA).

The reference's per-pair threadpool loop (ngsDist.cpp:244-262,325-404)
dissolves into tensor contractions over the full cohort:

  independent-genotypes path
      raw[i,j] = sum_s sum_{g,h} score[g,h] P[s,i,g] P[s,j,h]
               = einsum('sig,gh,sjh->ij') — one [N,3S]x[3S,N] matmul.
      Pairwise deletion becomes a validity mask folded into each side
      (valid_i*valid_j factorizes), plus a matching count contraction.

  EM path (non-independent genotypes)
      per-(pair,site) converged joint-genotype weights, reduced over
      sites: on a GPU in float32 by the fused kernel (ops/em_kernel.py),
      elsewhere by a lax.scan over site tiles of the batched EM
      (core/em.py), so the [pairs, sites, 9] weight tensor is never
      materialized in device memory.

  block bootstrap
      replicates are weighted resummations: either of per-block partial
      pair sums B[b,i,j] (cheap when n_blocks*N^2 fits memory) or of
      per-site multiplicity-weighted full contractions (memory-safe
      fallback) — no data copying, matching the reference's pointer
      aliasing semantics (ngsDist.cpp:416-437) without the pointers.

Everything here is shape-static and jit-compatible; the multi-device
sharding wrapper lives in ngsdist_jax/parallel/mesh.py.
"""

from __future__ import annotations

import functools
import os
from typing import Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..utils.hostmem import (PAD16, U16_ONE, CodedProbs, CodedSlab,
                             coded_upload_enabled, pack23, parallel_astype,
                             upload23_enabled)
from . import bootstrap as bt
from . import models
from .em import em_pair_site_contribs

EPSILON = 1e-5  # missing-data tolerance (gen_func.hpp:16)

# Partial-sum bootstrap path is used when the B (and C) tensors fit here.
PARTIALS_BUDGET_BYTES = 1 << 30
# Site-tile element budget for the EM scan (tile * n_pairs * 9 elements).
EM_TILE_ELEM_BUDGET = 1 << 25


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# Streamed loops double-buffer (the next chunk/round stages while the
# current one computes), so planners keep KEEP/DEN of the per-chunk
# budget for the current chunk's working set and reserve the rest for
# the prefetched tensor.  Tests derive expected chunk sizes from these.
PREFETCH_KEEP_NUM = 3
PREFETCH_KEEP_DEN = 4

# Streamed chunks must be small enough to PIPELINE, not merely to fit:
# the FIRST chunk's fused read/stage has nothing to overlap with, so a
# barely-over-budget genome split into two budget-sized chunks exposes
# half its read time serially.  Planners therefore target at least
# STREAM_MIN_CHUNKS rounds, floored at STREAM_MIN_CHUNK_SITES so the
# per-chunk dispatch + [N, N] result-fetch overhead stays amortized;
# the device budget remains the hard UPPER bound.
STREAM_MIN_CHUNKS = 16
STREAM_MIN_CHUNK_SITES = 16384


def _stream_chunk_sites(S: int, N: int, itemsize: int, budget: int) -> int:
    """Site-chunk length for the single-device streamed engine loops."""
    cap = max(1, (budget * PREFETCH_KEEP_NUM // PREFETCH_KEEP_DEN)
              // max(1, N * 3 * itemsize))
    depth = -(-S // STREAM_MIN_CHUNKS)
    return max(1, min(cap, max(depth, STREAM_MIN_CHUNK_SITES)))


# The engine's peak device footprint is a small multiple of the
# probability tensor itself: the EM kernel materializes a padded
# plane-major layout copy, and the XLA einsum engine two masked
# intermediates of the same shape.  The resident/chunk planner divides
# the budget by this factor so the PEAK stays within budget.
_WORKING_SET_FACTOR = 3

# Budget where the device reports no memory limit (the CPU backend).
HOST_DEVICE_BUDGET_BYTES = 12 << 30


# EM overlap stream floor: below ~4M triples the upload is too small
# for chunk overlap to beat the extra per-chunk dispatch/fetch.
EM_OVERLAP_MIN_TRIPLES = 1 << 22


def _device_budget_bytes() -> int:
    """Device-memory budget for the engine's per-dispatch working set
    (resident probability tensor PLUS its layout/masked copies); above
    it the engine streams site chunks sized budget/3.  Default: 3/4 of
    the memory the first local device lets this process allocate
    (memory_stats()["bytes_limit"]), or HOST_DEVICE_BUDGET_BYTES where
    the device reports none; NGSDIST_DEVICE_BUDGET overrides (bytes)."""
    raw = os.environ.get("NGSDIST_DEVICE_BUDGET")
    if raw:
        total = int(raw)
    else:
        stats = jax.local_devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        total = int(limit) * 3 // 4 if limit else HOST_DEVICE_BUDGET_BYTES
    return max(1, total // _WORKING_SET_FACTOR)


def use_em_kernel(dtype) -> bool:
    """Whether the EM path runs on the fused kernel (ops/em_kernel.py):
    on a GPU backend in float32.  CPU runs and x64 runs (which carry the
    md5 contract) take the XLA scan (_em_scan)."""
    return (jax.default_backend() == "gpu"
            and jnp.dtype(dtype) == jnp.float32)


@jax.jit
def expand23(P2: jnp.ndarray) -> jnp.ndarray:
    """[..., 2] -> [..., 3] with p2 = 1 - p0 - p1 (see
    hostmem.upload23_enabled).  Elementwise, so a NamedSharding on the
    input propagates.  Triples whose p0 carries the hostmem.PAD23
    sentinel expand to ALL-ZERO — mesh padding rows and data-borne
    (0,0,0) missing triples (empty-line text sites), which would
    otherwise reconstruct as confident (0,0,1) hom-alt genotypes.

    uint16 slabs (hostmem.pack16, NGSDIST_UPLOAD16) dequantize to f32
    as q * (1/65534) — one multiply, at most 1 ulp off at the q=65534
    endpoint (9.3e-10, four orders below the 7.6e-6 quantization
    half-step; the same ulp class as the documented coded-vs-pack23
    routing note).  Do NOT "fix" the endpoint with
    jnp.where(q == U16_ONE, 1.0, r): on the CPU backend that exact
    subtract-of-select-of-eq shape miscompiles inside a single-output
    loop fusion (the select silently yields its false branch;
    reproduced on jax 0.9.0 — tests/test_upload16.py pins the safe
    form).  Sentinel rows (p0 == PAD16) expand to the VALUE-PRESERVING
    uniform triple (v, v, v), v = p1/65534 — host-decided missing rows
    whose values still feed the non-pairwise-deletion unmasked sums
    (see the hostmem.U16_ONE note); pad tails ship p1 = 0 (all-zero,
    inert) and literal-nan rows p1 = PAD16 (all-NaN, keeps
    poisoning)."""
    if P2.dtype == jnp.uint16:
        pad = P2[..., 0:1] == PAD16
        r = P2.astype(jnp.float32) * np.float32(1.0 / U16_ONE)
        p2 = 1.0 - r[..., 0] - r[..., 1]
        P3 = jnp.concatenate([r, p2[..., None]], axis=-1)
        u = r[..., 1:2]  # sentinel rows: uniform value from the q1 lane
        P3 = jnp.where(pad, jnp.concatenate([u, u, u], axis=-1), P3)
        nan_row = pad & (P2[..., 1:2] == PAD16)
        return jnp.where(nan_row, jnp.float32(jnp.nan), P3)
    pad = P2[..., 0:1] > 1.5
    p2 = 1.0 - P2[..., 0] - P2[..., 1]
    P3 = jnp.concatenate([P2, p2[..., None]], axis=-1)
    return jnp.where(pad, jnp.zeros((), P2.dtype), P3)


def put_probs(P_slice: np.ndarray, dtype, may_zero: bool = True) -> jnp.ndarray:
    """Upload a [S, N, 3] host probability slab to the default device.

    f32 paths upload only the first two genotype components and
    reconstruct the third on device (hostmem.upload23_enabled, pack23);
    the host cast is threaded either way (serial first-touch of a fresh
    multi-hundred-MB buffer runs at page-fault speed on sandboxed
    hosts).  The dispatch is asynchronous: staged uploads overlap
    in-flight kernels.  may_zero=False (binary-read inputs, which
    cannot contain all-zero triples) skips pack23's sentinel scan.

    A [S, N, 2] slab is an already-packed upload (the fused native
    reader, io/readers.read_geno_pack23): uploaded as-is and expanded
    on device.
    """
    return _send_probs(_host_pack(P_slice, dtype, may_zero=may_zero))


def _host_pack(P_slice: np.ndarray, dtype, may_zero: bool = True) -> np.ndarray:
    """Host half of put_probs: the upload-ready slab (uint8 codes for
    coded tensors, packed f32 [S, N, 2] when upload23 is on, else a
    threaded cast), no device traffic.  Split out so streamed loops can
    run it on a thread that is NOT the one holding the device link
    (_pipelined_chunks)."""
    npdt = np.dtype(np.float64 if dtype == jnp.float64 else np.float32)
    if isinstance(P_slice, CodedSlab):  # deferred coded chunk: cast lut
        return CodedSlab(P_slice.codes, P_slice.lut.astype(npdt))
    if isinstance(P_slice, CodedProbs):
        if coded_upload_enabled(npdt):
            return CodedSlab(np.ascontiguousarray(P_slice.codes),
                             P_slice.lut.astype(npdt))
        P_slice = P_slice.P
    if P_slice.shape[-1] == 2:
        return P_slice
    if upload23_enabled(npdt):
        return pack23(P_slice, npdt, may_zero=may_zero)
    return parallel_astype(P_slice, npdt)


def _send_probs(arr) -> jnp.ndarray:
    """Device half of put_probs: ship a host-prepped slab; expand
    packed 2-component or coded uint8 uploads on device."""
    if isinstance(arr, CodedSlab):
        return expand_codes(jnp.asarray(arr.codes), jnp.asarray(arr.lut))
    if arr.shape[-1] == 2:
        return expand23(jnp.asarray(arr))
    return jnp.asarray(arr)


@jax.jit
def expand_codes(codes: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """[S, N] uint8 genotype codes + [K, 3] table -> [S, N, 3] probs.
    The code plane is the ONLY per-site host-link traffic (1 byte per
    (site, individual) vs 8 for the packed f32 slab).

    Expansion gathers each genotype component as its own [S, N] plane
    and stacks, exactly like expand23's concatenate."""
    idx = codes.astype(jnp.int32)
    return jnp.stack([jnp.take(lut[:, k], idx, axis=0) for k in range(3)],
                     axis=-1)


def _pipelined_chunks(ranges, read_fn, send_fn):
    """Yield send_fn(read_fn(rng)) for each range with disk/parse work
    and host->device sends on SEPARATE single threads.

    The host->device copy inside send_fn can block its thread for the
    full transfer, so a single staging thread would serialize reads
    against the copy.  Two stages restore the overlap: read k+1 parses
    while send k drains.  Depth
    is bounded — one read-ahead slab plus at most two slabs in the
    send stage (one in flight, one queued) — so host footprint stays
    within the prefetch reserve the chunk planner already assumes.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if not ranges:
        return
    with ThreadPoolExecutor(1) as rex, ThreadPoolExecutor(1) as sex:
        rfut = rex.submit(read_fn, ranges[0])
        sends: deque = deque()
        for k in range(len(ranges)):
            item = rfut.result()
            if k + 1 < len(ranges):
                rfut = rex.submit(read_fn, ranges[k + 1])
            sends.append(sex.submit(send_fn, item))
            if len(sends) > 1:
                yield sends.popleft().result()
        while sends:
            yield sends.popleft().result()


# Fused-read upload pipelining: per-chunk packed bytes of the chunks
# streamed to the device while the NEXT chunk is read from disk
# (jax.device_put dispatches asynchronously — the host->device copy of
# chunk k is in flight while the fused reader parses chunk k+1).
PIPE_UPLOAD_BYTES = 32 << 20


def _pipe_upload_bytes() -> int:
    """Fused-upload chunk granularity (NGSDIST_PIPE_UPLOAD_BYTES
    overrides).  Smaller chunks expose less of the FIRST chunk's fused
    read before its upload can start (the pipeline's only unoverlapped
    read) at the cost of one more dispatch per chunk."""
    v = os.environ.get("NGSDIST_PIPE_UPLOAD_BYTES")
    return max(1 << 20, int(v)) if v else PIPE_UPLOAD_BYTES


def _upload_packed_pipelined(src, n_used: int, dtype=None) -> jnp.ndarray:
    """Resident upload of a fused-read source (readers.PackedBinInput
    packed f32 slabs, or readers.CodedBinInput uint8 CodedSlab chunks):
    read slabs from disk and dispatch each async upload immediately,
    then assemble and expand ON DEVICE.  One pass over the file, no
    resident f64 tensor.  The NEXT chunk's fused read runs in a
    prefetch thread because device_put applies backpressure (it blocks
    until the in-flight transfer drains) — without the thread, disk
    reads and host-link copies ping-pong serially."""
    from concurrent.futures import ThreadPoolExecutor

    N = src.n_ind
    bps = getattr(src, "bytes_per_site", N * 8)  # uint8 codes: N
    step = max(1, _pipe_upload_bytes() // max(1, bps))
    ranges = [(lo, min(lo + step, n_used)) for lo in range(0, n_used, step)]
    parts = []
    lut = None
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(src.read_packed, *ranges[0])
        for k in range(len(ranges)):
            buf = fut.result()
            if k + 1 < len(ranges):
                fut = ex.submit(src.read_packed, *ranges[k + 1])
            if isinstance(buf, CodedSlab):
                lut = buf.lut
                parts.append(jnp.asarray(buf.codes))
            else:
                parts.append(jnp.asarray(buf))
    P2 = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    del parts
    if lut is not None:
        npdt = np.float64 if dtype == jnp.float64 else np.float32
        return expand_codes(P2, jnp.asarray(lut.astype(npdt)))
    return expand23(P2)


def missing_mask(P: jnp.ndarray) -> jnp.ndarray:
    """[S, N] True where the genotype is missing: all three probabilities
    within EPSILON (miss_data, gen_func.cpp:862-868)."""
    d01 = jnp.abs(P[..., 0] - P[..., 1])
    d12 = jnp.abs(P[..., 1] - P[..., 2])
    return (d01 < EPSILON) & (d12 < EPSILON)


# ------------------------------------------------------------------ #
# Independent-genotypes path                                          #
# ------------------------------------------------------------------ #


@functools.partial(jax.jit, static_argnames=("pairwise_del",))
def indep_suffstats(
    P: jnp.ndarray,
    score: jnp.ndarray,
    pairwise_del: bool,
    site_weights: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Sufficient statistics for the independent path.

    P: [S, N, 3] normal-space probabilities.  Returns (raw [N,N],
    cnt [N,N] or None).  site_weights (optional [S]) weight each site's
    contribution (bootstrap multiplicities); applied once per site.
    """
    dtype = P.dtype
    if pairwise_del:
        valid = (~missing_mask(P)).astype(dtype)
        Q = P * valid[..., None]
    else:
        valid = None
        Q = P
    Y = jnp.einsum("sjh,gh->sjg", Q, score.astype(dtype),
                   precision=jax.lax.Precision.HIGHEST)
    L = Q if site_weights is None else Q * site_weights[:, None, None].astype(dtype)
    raw = jnp.einsum("sig,sjg->ij", L, Y, preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)
    cnt = None
    if pairwise_del:
        vw = valid if site_weights is None else valid * site_weights[:, None].astype(dtype)
        cnt = jnp.einsum("si,sj->ij", vw, valid, preferred_element_type=dtype,
                         precision=jax.lax.Precision.HIGHEST)
    return raw, cnt


@functools.partial(jax.jit, static_argnames=("pairwise_del", "n_blocks", "block_size"))
def indep_block_partials(
    P_trunc: jnp.ndarray,
    score: jnp.ndarray,
    pairwise_del: bool,
    n_blocks: int,
    block_size: int,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Per-block partial sums B [n_blocks, N, N] (and counts C) over the
    truncated site range, for bootstrap resummation."""
    dtype = P_trunc.dtype
    S, N, _ = P_trunc.shape
    assert S == n_blocks * block_size
    if pairwise_del:
        valid = (~missing_mask(P_trunc)).astype(dtype)
        Q = P_trunc * valid[..., None]
    else:
        valid = None
        Q = P_trunc
    Qb = Q.reshape(n_blocks, block_size, N, 3)
    Yb = jnp.einsum("bsjh,gh->bsjg", Qb, score.astype(dtype),
                    precision=jax.lax.Precision.HIGHEST)
    B = jnp.einsum("bsig,bsjg->bij", Qb, Yb, preferred_element_type=dtype,
                   precision=jax.lax.Precision.HIGHEST)
    C = None
    if pairwise_del:
        vb = valid.reshape(n_blocks, block_size, N)
        C = jnp.einsum("bsi,bsj->bij", vb, vb, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    return B, C


# ------------------------------------------------------------------ #
# EM path                                                             #
# ------------------------------------------------------------------ #


def _pair_indices(n_ind: int) -> Tuple[np.ndarray, np.ndarray]:
    iu = np.triu_indices(n_ind, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def _em_tile_size(n_pairs: int, block_size: Optional[int], n_sites: int = 0) -> int:
    tile = max(1, EM_TILE_ELEM_BUDGET // max(1, n_pairs * 9))
    if n_sites:
        tile = min(tile, n_sites)  # never pad beyond the data
    if block_size:
        tile = max(block_size, (tile // block_size) * block_size)
    return tile


@functools.partial(
    jax.jit, static_argnames=("pairwise_del", "tile", "block_size", "want_blocks")
)
def _em_scan(
    P_pad: jnp.ndarray,        # [S_pad, N, 3], zero-padded
    site_mask: jnp.ndarray,    # [S_pad] 1.0 for real sites
    score9: jnp.ndarray,       # [9]
    I: jnp.ndarray,            # [n_pairs] first individual of each pair
    J: jnp.ndarray,            # [n_pairs] second individual of each pair
    site_weights: jnp.ndarray, # [S_pad] per-site multiplicities (ones if unused)
    pairwise_del: bool,
    tile: int,
    block_size: int,
    want_blocks: bool,
):
    """Scan site tiles; per tile, run the batched EM for all pairs and
    accumulate weighted raw pair sums, valid counts and (optionally)
    per-block partial sums collected as scan outputs."""
    dtype = P_pad.dtype
    S_pad = P_pad.shape[0]
    n_tiles = S_pad // tile
    n_pairs = I.shape[0]
    bpt = tile // block_size if want_blocks else 1

    Pt = P_pad.reshape(n_tiles, tile, P_pad.shape[1], 3)
    mt = site_mask.reshape(n_tiles, tile)
    wt = site_weights.reshape(n_tiles, tile)

    def body(carry, xs):
        raw, cnt = carry
        Ptile, mtile, wtile = xs
        P1 = Ptile[:, I, :]  # [tile, n_pairs, 3]
        P2 = Ptile[:, J, :]
        contrib = em_pair_site_contribs(P1, P2, score9)  # [tile, n_pairs]
        m = mtile[:, None]
        if pairwise_del:
            valid = (~missing_mask(Ptile)).astype(dtype)  # [tile, N]
            m = m * (valid[:, I] * valid[:, J])
        c_eff = contrib * m                   # unweighted effective contribs
        w = wtile[:, None]
        raw = raw + jnp.sum(c_eff * w, axis=0)
        cnt = cnt + jnp.sum(m * w, axis=0)
        ys = ()
        if want_blocks:
            seg = jax.lax.broadcasted_iota(jnp.int32, (tile, 1), 0)[:, 0] // block_size
            Bt = jax.ops.segment_sum(c_eff, seg, num_segments=bpt)
            Ct = jax.ops.segment_sum(
                jnp.broadcast_to(m, c_eff.shape), seg, num_segments=bpt
            )
            ys = (Bt, Ct)
        return (raw, cnt), ys

    init = (jnp.zeros((n_pairs,), dtype), jnp.zeros((n_pairs,), dtype))
    (raw, cnt), ys = jax.lax.scan(body, init, (Pt, mt, wt))
    B = C = None
    if want_blocks:
        B = ys[0].reshape(n_tiles * bpt, n_pairs)
        C = ys[1].reshape(n_tiles * bpt, n_pairs)
    return raw, cnt, B, C


def _fetch_pair(raw, cnt):
    """Fetch (raw, cnt) device arrays as ONE device->host transfer by
    stacking on device: each fetch pays a fixed round-trip latency
    that would otherwise double (cheap no-op
    pass-through for host arrays / cnt=None / mismatched shapes)."""
    if (cnt is None or isinstance(raw, np.ndarray)
            or isinstance(cnt, np.ndarray)
            or getattr(raw, "shape", None) != getattr(cnt, "shape", None)
            or raw.dtype != cnt.dtype):
        return raw, cnt
    both = np.asarray(jnp.stack([raw, cnt]))
    return both[0], both[1]


def _scatter_pairs(vals: np.ndarray, I: np.ndarray, J: np.ndarray, n_ind: int) -> np.ndarray:
    out = np.zeros(vals.shape[:-1] + (n_ind, n_ind), dtype=np.float64)
    out[..., I, J] = vals
    out[..., J, I] = vals
    return out


def _stream_block_rows(n_rows: int, n_rounds: int, chunk: int, s_loc: int,
                       n_dev: int, bs: int, n_blocks: int) -> np.ndarray:
    """row -> TRUE global block id for pm.concat_block_rounds' layout
    (device-major, rounds concatenated per device, per-round pad rows
    in place); -1 marks pad rows and blocks >= n_blocks (truncation
    tail / global padding).  Requires bs | chunk and bs | s_loc, which
    the SiteStream planner guarantees (chunk and s_loc are block-size
    multiples whenever bootstrap runs)."""
    assert chunk % bs == 0 and s_loc % bs == 0, (chunk, s_loc, bs)
    rows_per_dev = n_rows // n_dev
    bpc = chunk // bs
    lpb = s_loc // bs
    out = np.full((n_rows,), -1, np.int64)
    for d in range(n_dev):
        for r in range(n_rounds):
            for j in range(bpc):
                lo = r * chunk + j * bs
                if lo >= s_loc:
                    continue
                g = d * lpb + lo // bs
                if g < n_blocks:
                    out[d * rows_per_dev + r * bpc + j] = g
    return out


def _em_zero_rows(P, include=None):
    """Per-individual presence of DATA-BORNE all-zero triples [N] bool
    among the included sites.  Empty-line text sites parse to (0,0,0)
    triples; on the EM path WITHOUT pairwise deletion the reference
    runs em2 on them anyway, whose zero 9-cell weight matrix drives the
    loglik to NaN — poisoning every pair that touches the individual
    at an included site (ngsDist.cpp:348-349 + emOptim2.cpp loglik;
    under pairwise deletion miss_data skips them, so no poison).  The
    engines' kernels EXCLUDE zero rows, so parity needs the poison
    re-applied after the fact (round-5 fuzz trial 302)."""
    Z = jnp.all(P == 0, axis=-1)
    if include is not None:
        Z = Z & include[:, None]
    return jnp.any(Z, axis=0)


def _em_poison_pairs(raw_v, z, I, J):
    """NaN the pair-vector entries whose either member has a zero row
    (see _em_zero_rows)."""
    bad = z[I] | z[J]
    return jnp.where(bad, jnp.asarray(jnp.nan, raw_v.dtype), raw_v)


def em_suffstats(
    P: jnp.ndarray,
    score9: jnp.ndarray,
    pairwise_del: bool,
    site_weights: Optional[np.ndarray] = None,
    n_blocks: Optional[int] = None,
    block_size: Optional[int] = None,
):
    """EM-path sufficient statistics.

    Returns (raw [n_pairs], cnt [n_pairs] or None, B [n_blocks, n_pairs]
    or None, C or None) as device arrays; pair order is triu row-major.
    """
    S, N, _ = P.shape
    I, J = _pair_indices(N)
    n_pairs = len(I)
    want_blocks = n_blocks is not None
    tile = _em_tile_size(n_pairs, block_size if want_blocks else None, S)
    if want_blocks:
        assert S == n_blocks * block_size
    S_pad = ((S + tile - 1) // tile) * tile
    pad = S_pad - S
    P_pad = jnp.pad(P, ((0, pad), (0, 0), (0, 0)))
    mask = jnp.pad(jnp.ones((S,), P.dtype), (0, pad))
    if site_weights is not None:
        w = jnp.pad(jnp.asarray(site_weights, P.dtype), (0, pad))
    else:
        w = jnp.ones((S_pad,), P.dtype)
    raw, cnt, B, C = _em_scan(
        P_pad, mask, score9, jnp.asarray(I), jnp.asarray(J), w,
        pairwise_del, tile, block_size if want_blocks else 1, want_blocks,
    )
    if B is not None:
        # padded tail spilled into phantom block rows; drop them
        B = B[:n_blocks]
        C = C[:n_blocks]
    return raw, cnt, B, C


def em_pair_stats(P: jnp.ndarray, score9, pairwise_del: bool,
                  site_weights=None):
    """EM-path (raw, cnt) pair vectors (triu row-major order) for a
    resident [S, N, 3] tensor: the EM kernel where use_em_kernel says
    so, the XLA scan otherwise."""
    if use_em_kernel(P.dtype):
        from ..ops import em_kernel

        I, J = _pair_indices(P.shape[1])
        raw_m, cnt_m = em_kernel.em_raw_cnt(P, score9, pairwise_del,
                                            site_weights=site_weights)
        return raw_m[I, J], cnt_m[I, J]
    raw, cnt, _, _ = em_suffstats(P, score9, pairwise_del,
                                  site_weights=site_weights)
    return raw, cnt


# ------------------------------------------------------------------ #
# Replicate orchestration                                             #
# ------------------------------------------------------------------ #


def _finalize(raw: np.ndarray, cnt, pars: Params, on_stats=None) -> np.ndarray:
    """raw/cnt -> averaged, model-corrected float64 matrix with zero diag.

    on_stats(raw, cnt): pre-correction sufficient statistics hook with
    the TRUE valid-site count — the reference's verbose>=3 report prints
    cnt before the --tot_sites override (ngsDist.cpp:366-373), and the
    throughput meter counts the updates the hot loop actually executed."""
    raw = np.asarray(raw, dtype=np.float64)
    true_cnt = None if cnt is None else (
        np.asarray(cnt, dtype=np.float64) if isinstance(cnt, np.ndarray) else float(cnt)
    )
    if pars.tot_sites > 0:
        denom = float(pars.tot_sites)
    elif cnt is None:
        raise ValueError("cnt required when tot_sites is not set")
    else:
        denom = true_cnt
    if on_stats is not None:
        on_stats(raw, true_cnt if true_cnt is not None else denom)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = raw / denom
        d = models.apply_evol_model(d, pars.evol_model, xp=np)
    if d.ndim == 2:
        np.fill_diagonal(d, 0.0)
    return d


def iter_replicates(
    pars: Params,
    P_host: np.ndarray,
    maps: List[np.ndarray],
    n_trunc: int,
    mesh=None,
    on_stats=None,
    alleles=None,
    start_rep: int = 0,
    round_ckpt: bool = False,
) -> Iterator[np.ndarray]:
    """Yield the full-data matrix then one matrix per bootstrap replicate,
    computed with the batched engine.

    round_ckpt: persist accumulated sufficient statistics after every
    streamed site round (long-genome runs) so interruption mid-replicate
    loses at most one round; enabled by the runner when it owns the
    output file.

    With a `jax.sharding.Mesh` the site axis is sharded across its
    devices and per-shard partial sums are psum-merged
    (parallel/mesh.py); otherwise everything runs single-device.

    alleles: (a1, a2) int8 site allele codes (core/submodels.py) —
    required for the extended evolutionary models 3-6, which the jax
    engine implements (the reference and the exact engine abort on
    them).  With a mesh, the extended path shards exactly like models
    0-2: the class masks are site-weight vectors through
    pm.sharded_suffstats, and the per-pair base frequencies are a
    sharded contraction (pm.sharded_pair_pi).
    """
    if pars.evol_model >= 3:
        yield from _iter_replicates_extended(
            pars, P_host, maps, n_trunc, alleles, on_stats, mesh=mesh,
            start_rep=start_rep, round_ckpt=round_ckpt,
        )
        return
    if mesh is not None:
        yield from _iter_replicates_sharded(
            pars, P_host, maps, n_trunc, mesh, on_stats=on_stats,
            start_rep=start_rep, round_ckpt=round_ckpt,
        )
        return
    dtype = default_dtype()
    N = pars.n_ind
    S = pars.n_sites
    score = jnp.asarray(pars.score, dtype)
    score9 = score.reshape(-1)
    # NOTE: the probability tensor is only device-put below once the
    # chunk-streaming decision is made (NGSDIST_DEVICE_BUDGET) — an
    # unconditional jnp.asarray here would defeat streaming.

    I, J = _pair_indices(N)

    def full_stats(Psub, site_weights=None, n_blocks=None, block_size=None):
        if pars.indep_geno:
            w = None if site_weights is None else jnp.asarray(site_weights, dtype)
            if n_blocks is None:
                raw, cnt = indep_suffstats(Psub, score, pars.pairwise_del, w)
                return raw, cnt, None, None
            B, C = indep_block_partials(Psub, score, pars.pairwise_del, n_blocks, block_size)
            return None, None, B, C
        def em_poison(raw_v):
            # reference parity for data-borne zero rows (_em_zero_rows);
            # binary inputs cannot contain one (every parsed row
            # normalizes to sum 1), so skip the scan like pack23's
            # may_zero gate
            if pars.pairwise_del or pars.in_bin:
                return raw_v
            inc = (None if site_weights is None
                   else jnp.asarray(site_weights, Psub.dtype) > 0)
            return _em_poison_pairs(raw_v, _em_zero_rows(Psub, inc),
                                    jnp.asarray(I), jnp.asarray(J))

        if n_blocks is None:
            # Weighted or not: per-site weights stream in as a vector,
            # so bootstrap replicates reuse one compiled shape.
            raw, cnt = em_pair_stats(Psub, score9, pars.pairwise_del,
                                     site_weights=site_weights)
            return em_poison(raw), cnt, None, None
        return em_suffstats(
            Psub, score9, pars.pairwise_del,
            site_weights=site_weights, n_blocks=n_blocks, block_size=block_size,
        )

    def to_matrix(raw, cnt):
        raw, cnt = _fetch_pair(raw, cnt)
        if raw.ndim == 1:  # pair-vector (EM path)
            raw_m = _scatter_pairs(np.asarray(raw, np.float64), I, J, N)
            cnt_m = None if cnt is None else _scatter_pairs(np.asarray(cnt, np.float64), I, J, N)
        else:
            raw_m = np.asarray(raw, np.float64)
            cnt_m = None if cnt is None else np.asarray(cnt, np.float64)
        return raw_m, cnt_m

    # Long genomes: when [S, N, 3] exceeds the device budget, stream
    # site chunks through the engine and accumulate the [pairs]/[N,N]
    # sufficient statistics (the analogue of sequence-length scaling —
    # the site reduction is a plain sum, SURVEY.md §5).
    itemsize = np.dtype(np.float64 if dtype == jnp.float64 else np.float32).itemsize
    budget = _device_budget_bytes()
    chunked = S * N * 3 * itemsize > budget
    chunk = _stream_chunk_sites(S, N, itemsize, budget) if chunked else S
    if not chunked and not maps and not pars.indep_geno \
            and dtype == jnp.float32 and S * N >= EM_OVERLAP_MIN_TRIPLES \
            and jax.default_backend() != "cpu":
        # EM overlap stream: the EM path is compute-bound, so even
        # when the tensor fits residency, streaming ~4 chunks hides
        # each chunk's upload under the previous chunk's kernel.  f32
        # device backends only (the x64
        # md5 contract and CPU-backend golden tolerances keep their
        # resident accumulation order), and only WITHOUT bootstrap:
        # replicates reuse the resident device tensor, which chunking
        # would trade for per-replicate re-reads.
        chunked = True
        chunk = -(-S // 4)
    # Fused-read source (runner fast path): packed f32 chunks stream
    # from disk straight to the device — no resident host f64 tensor.
    packed_src = hasattr(P_host, "read_packed")
    if not chunked:
        P = (_upload_packed_pipelined(P_host, S, dtype) if packed_src
             else put_probs(P_host, dtype, may_zero=not pars.in_bin))

    def stats_stream(site_weights=None, n_used=S, rep=0):
        if not chunked:
            Psub = P if n_used == S else P[:n_used]
            raw, cnt, _, _ = full_stats(Psub, site_weights=site_weights)
            return raw, cnt
        # Chunked accumulation runs host-side in float64 so partial
        # sums can checkpoint per round (utils/checkpoint.save_rounds)
        # and a resumed run is byte-identical (round_ckpt in
        # iter_replicates' signature gates the file writes).
        acc_raw = acc_cnt = None
        skip = 0
        if round_ckpt:
            from ..utils import checkpoint as ckpt_mod

            got = ckpt_mod.load_rounds(pars.out, pars, rep, engine="jax")
            if got is not None:
                skip, arrs = got
                acc_raw = arrs["raw"]
                acc_cnt = arrs.get("cnt")

        # Two-stage staging (_pipelined_chunks): the fused disk read /
        # pack runs on one thread while ANOTHER thread holds the device
        # link, so parse time hides under the in-flight transfer
        # instead of serializing with it.
        def read_host(rng_):
            start, stop = rng_
            arr = _host_pack(
                P_host.read_packed(start, stop) if packed_src
                else P_host[start:stop],
                dtype, may_zero=not pars.in_bin)
            wc = None if site_weights is None else site_weights[start:stop]
            return arr, wc

        def send(item):
            arr, wc = item
            return _send_probs(arr), wc

        ranges = [(s, min(s + chunk, n_used))
                  for s in range(0, n_used, chunk)][skip:]
        idx = skip
        for Pc, wc in _pipelined_chunks(ranges, read_host, send):
            raw, cnt, _, _ = full_stats(Pc, site_weights=wc)
            raw = np.asarray(raw, np.float64)
            acc_raw = raw if acc_raw is None else acc_raw + raw
            if cnt is not None:
                cnt = np.asarray(cnt, np.float64)
                acc_cnt = cnt if acc_cnt is None else acc_cnt + cnt
            idx += 1
            if round_ckpt:
                arrs = {"raw": acc_raw}
                if acc_cnt is not None:
                    arrs["cnt"] = acc_cnt
                ckpt_mod.save_rounds(pars.out, pars, rep, idx, arrs,
                                     engine="jax")
        return acc_raw, acc_cnt

    # Replicate 0: full dataset (skipped entirely on resume).
    if start_rep == 0:
        raw, cnt = stats_stream()
        raw_m, cnt_m = to_matrix(raw, cnt)
        denom = cnt_m if pars.pairwise_del else float(S)
        yield _finalize(raw_m, denom, pars, on_stats)

    n_reps = pars.n_boot_rep
    if n_reps == 0 or start_rep > n_reps:
        return
    block_size = pars.boot_block_size
    n_blocks = n_trunc // block_size

    partial_bytes = n_blocks * N * N * itemsize * (2 if pars.pairwise_del else 1)
    use_partials = (not chunked) and partial_bytes <= PARTIALS_BUDGET_BYTES

    table = bt.block_index_table(pars.seed, n_reps, n_blocks)

    if use_partials:
        _, _, B, C = full_stats(P[:n_trunc], n_blocks=n_blocks, block_size=block_size)
        M = jnp.asarray(bt.block_multiplicity(table, n_blocks), dtype)
        if B.ndim == 2:  # EM path: [n_blocks, n_pairs]
            raw_r = jnp.einsum("rb,bp->rp", M, B, preferred_element_type=dtype,
                               precision=jax.lax.Precision.HIGHEST)
            cnt_r = None if C is None else jnp.einsum("rb,bp->rp", M, C, preferred_element_type=dtype,
                                                          precision=jax.lax.Precision.HIGHEST)
            if not pars.pairwise_del and not pars.in_bin:
                # per-BLOCK zero-row flags (the partials stay clean so
                # unsampled blocks cannot poison); a replicate is
                # poisoned exactly where it SAMPLES a zero-row block
                # (_em_zero_rows parity; binary inputs skip the scan —
                # they cannot contain zero rows).  {0,1} operands are
                # exact at any precision; HIGHEST per the einsum rule.
                zrow = jnp.all(jnp.asarray(P[:n_trunc]) == 0, axis=-1)
                zB = jnp.any(zrow.reshape(n_blocks, block_size, N), axis=1)
                z_rep = jnp.einsum("rb,bn->rn", (M > 0).astype(dtype),
                                   zB.astype(dtype),
                                   precision=jax.lax.Precision.HIGHEST) > 0
                Ii, Jj = jnp.asarray(I), jnp.asarray(J)
                bad = z_rep[:, Ii] | z_rep[:, Jj]
                raw_r = jnp.where(bad, jnp.asarray(jnp.nan, raw_r.dtype),
                                  raw_r)
        else:
            raw_r = jnp.einsum("rb,bij->rij", M, B, preferred_element_type=dtype,
                               precision=jax.lax.Precision.HIGHEST)
            cnt_r = None if C is None else jnp.einsum("rb,bij->rij", M, C, preferred_element_type=dtype,
                                                          precision=jax.lax.Precision.HIGHEST)
        for r in range(n_reps):
            if r + 1 < start_rep:
                continue
            raw_m, cnt_m = to_matrix(raw_r[r], None if cnt_r is None else cnt_r[r])
            denom = cnt_m if pars.pairwise_del else float(n_trunc)
            yield _finalize(raw_m, denom, pars, on_stats)
    else:
        reps = [r for r in range(n_reps) if r + 1 >= start_rep]

        def dispatch(r):
            w = np.bincount(maps[r], minlength=n_trunc).astype(np.float64)
            return stats_stream(site_weights=w, n_used=n_trunc, rep=r + 1)

        # Resident runs: dispatch replicate r+1's kernel (async) BEFORE
        # fetching replicate r — the device computes the next weighted
        # replicate while the host blocks on the previous fetch, the
        # model correction and the phylip write.  Chunked streams fetch
        # inside stats_stream, so lookahead would just compute a whole
        # replicate early (wasted on a graceful stop) — skipped.
        lookahead = not chunked
        pending = dispatch(reps[0]) if (reps and lookahead) else None
        for k, r in enumerate(reps):
            if lookahead:
                raw, cnt = pending
                if k + 1 < len(reps):
                    pending = dispatch(reps[k + 1])
            else:
                raw, cnt = dispatch(r)
            raw_m, cnt_m = to_matrix(raw, cnt)
            denom = cnt_m if pars.pairwise_del else float(n_trunc)
            yield _finalize(raw_m, denom, pars, on_stats)


def _broadcast_f64_exact(a: np.ndarray) -> np.ndarray:
    """broadcast_one_to_all of an f64 array, bit-exact under x64-off.

    broadcast_one_to_all device_puts its argument, which silently
    truncates f64 to f32 whenever x64 is disabled (every f32 device run).
    Round-checkpoint accumulators are host-f64 sums of f32 rounds —
    generally not f32-representable — and a resumed run must reproduce
    an uninterrupted run bit-for-bit, so the broadcast rides a uint8
    view of the bytes instead."""
    from jax.experimental import multihost_utils as mhu

    b = np.asarray(mhu.broadcast_one_to_all(
        np.ascontiguousarray(a).view(np.uint8)))
    return np.ascontiguousarray(b).view(np.float64).reshape(a.shape)


def _round_ckpt_resume(pars: Params, rep: int, shapes, round_ckpt: bool):
    """(skip, {key: float64 array} | None): round-checkpoint resume
    state for streamed collective paths.  Only process 0 keeps the
    sidecar; the state is broadcast (fixed `shapes`) so every process
    re-enters the SAME round and the collective stream stays aligned."""
    if not round_ckpt:
        return 0, None
    import jax

    from ..utils import checkpoint as ckpt_mod

    got = None
    if jax.process_index() == 0:
        got = ckpt_mod.load_rounds(pars.out, pars, rep, engine="jax")
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mhu

        skip = np.int32(got[0]) if got else np.int32(0)
        arrs = {}
        for k, shp in shapes.items():
            a = (np.asarray(got[1][k], np.float64)
                 if got and k in got[1] else np.zeros(shp))
            arrs[k] = _broadcast_f64_exact(a)
        skip = int(mhu.broadcast_one_to_all(skip))
        if skip == 0:
            return 0, None
        return skip, arrs
    if got is None:
        return 0, None
    return got[0], dict(got[1])


def _as_stream(pars: Params, P_src, mesh):
    """Normalize the sharded engine's input into a SiteStream (or None
    for a prebuilt legacy global array)."""
    from ..parallel.multihost import SiteStream

    if isinstance(P_src, SiteStream):
        return P_src
    if isinstance(P_src, (np.ndarray, CodedProbs)):
        dtype = default_dtype()
        np_dtype = np.float64 if dtype == jnp.float64 else np.float32
        return SiteStream.from_array(P_src, pars, mesh, np_dtype)
    return None  # prebuilt jax.Array


def _iter_replicates_sharded(
    pars: Params, P_src, maps: List[np.ndarray], n_trunc: int, mesh,
    on_stats=None, start_rep: int = 0, round_ckpt: bool = False,
) -> Iterator[np.ndarray]:
    """Mesh-sharded replicate stream (sites sharded, psum-merged).

    P_src: numpy [S, N, 3], a SiteStream, or a prebuilt padded global
    jax.Array.  When the per-device shard exceeds NGSDIST_DEVICE_BUDGET
    the stream iterates fixed-shape site rounds (SiteStream) and every
    matrix — full data and bootstrap replicates alike — is a weighted
    sum of per-round sharded sufficient statistics, so per-device HBM
    no longer bounds genome length (SURVEY.md §5 long-context)."""
    from ..parallel import mesh as pm

    dtype = default_dtype()
    N = pars.n_ind
    S = pars.n_sites
    score = pars.score
    I, J = _pair_indices(N)
    n_reps = pars.n_boot_rep

    stream = _as_stream(pars, P_src, mesh)
    if stream is None:
        arr = P_src          # legacy prebuilt resident array
        streaming = False
    elif stream.resident:
        arr = stream.global_array()
        streaming = False
    else:
        arr = None
        streaming = True

    def to_matrix(raw, cnt):
        raw = np.asarray(raw, np.float64)
        if raw.ndim == 1:
            raw_m = _scatter_pairs(raw, I, J, N)
            cnt_m = None if cnt is None else _scatter_pairs(np.asarray(cnt, np.float64), I, J, N)
        else:
            raw_m = raw
            cnt_m = None if cnt is None else np.asarray(cnt, np.float64)
        return raw_m, cnt_m

    if streaming:
        import jax

        def _ckpt_resume(rep: int):
            """(skip, acc_raw, acc_cnt) from a round checkpoint
            (process-0 sidecar, broadcast — _round_ckpt_resume)."""
            rshape = (N, N) if pars.indep_geno else (len(I),)
            shapes = {"raw": rshape}
            if pars.pairwise_del or not pars.indep_geno:
                shapes["cnt"] = rshape
            skip, arrs = _round_ckpt_resume(pars, rep, shapes, round_ckpt)
            if arrs is None:
                return 0, None, None
            return skip, arrs["raw"], arrs.get("cnt")

        def stats_rounds(w_full: np.ndarray, rep: int = 0):
            skip, acc_raw, acc_cnt = _ckpt_resume(rep)
            rounds = list(range(skip, stream.n_rounds))
            # One-round lookahead: stage the next round's shard (host
            # assembly + async device transfer) while the current
            # round's suffstats are in flight; the SiteStream planner
            # budgets for the extra resident round (_plan's 3/4).
            pending = ((stream.round_data(rounds[0]),
                        stream.round_cols(rounds[0], w_full))
                       if rounds else None)
            for k, r in enumerate(rounds):
                Pr, wr = pending
                raw, cnt, _, _ = pm.sharded_suffstats(
                    Pr, score, mesh, indep=pars.indep_geno,
                    pairwise_del=pars.pairwise_del, site_weights=wr,
                    dtype=dtype, n_sites=int(Pr.shape[0]),
                    may_zero=not pars.in_bin,
                )
                if k + 1 < len(rounds):
                    nr = rounds[k + 1]
                    pending = (stream.round_data(nr),
                               stream.round_cols(nr, w_full))
                raw = np.asarray(raw, np.float64)
                acc_raw = raw if acc_raw is None else acc_raw + raw
                if cnt is not None:
                    cnt = np.asarray(cnt, np.float64)
                    acc_cnt = cnt if acc_cnt is None else acc_cnt + cnt
                if round_ckpt and jax.process_index() == 0:
                    from ..utils import checkpoint as ckpt_mod

                    arrs = {"raw": acc_raw}
                    if acc_cnt is not None:
                        arrs["cnt"] = acc_cnt
                    ckpt_mod.save_rounds(pars.out, pars, rep, r + 1, arrs, engine="jax")
            return acc_raw, acc_cnt

        # Indep bootstrap over streamed rounds: ONE data pass yields
        # per-block partial sums, concatenated per device across rounds.
        # The concatenated row order is DEVICE-MAJOR with per-round pad
        # rows in place: row (d, r, j) covers global block
        # d*(s_loc/bs) + (r*chunk + j*bs)/bs only while r*chunk + j*bs
        # < s_loc — when the round chunk does not divide s_loc, the
        # ragged last round leaves pad rows INSIDE each device's range,
        # so positional multiplicity vectors silently drop trailing
        # devices' blocks (round-5 routing fuzz trial 507: 5e-2 errors
        # at chunk=3, s_loc=14).  _stream_block_rows builds the true
        # row->block map and the resummation weights are PERMUTED into
        # row order (pads and tail rows get weight 0).  Every replicate
        # is then a cheap resum instead of a full weighted data pass
        # (R+1 passes -> 1 + tail).  Durability is replicate-level on
        # this path (no per-round sidecars: a kill recomputes the
        # single pass; the replicates after it are nearly free).
        bs = pars.boot_block_size
        n_blocks_s = n_trunc // bs if n_reps else 0
        itemsize_s = 8 if dtype == jnp.float64 else 4
        partial_bytes_s = (n_blocks_s * N * N * itemsize_s
                           * (2 if pars.pairwise_del else 1))
        if (pars.indep_geno and n_reps > 0 and pm.pairs_size(mesh) == 1
                and 0 < partial_bytes_s <= PARTIALS_BUDGET_BYTES):
            rb = stream.round_sites // bs
            B_rs, C_rs = [], []
            rounds = list(range(stream.n_rounds))
            pending = stream.round_data(rounds[0]) if rounds else None
            for k, r in enumerate(rounds):
                Pr = pending
                _, _, B_r, C_r = pm.sharded_suffstats(
                    Pr, score, mesh, indep=True,
                    pairwise_del=pars.pairwise_del,
                    n_blocks=rb, block_size=bs, dtype=dtype,
                    n_sites=int(Pr.shape[0]),
                )
                if k + 1 < len(rounds):
                    pending = stream.round_data(rounds[k + 1])
                B_rs.append(B_r)
                if C_r is not None:
                    C_rs.append(C_r)
            B = pm.concat_block_rounds(B_rs, mesh)
            C = pm.concat_block_rounds(C_rs, mesh) if C_rs else None

            # True row -> global block id of the device-major layout
            # (-1 for in-round pad rows and blocks >= n_blocks_s, i.e.
            # the truncation tail and global padding).
            row2block = _stream_block_rows(
                int(B.shape[0]), stream.n_rounds, stream.chunk,
                stream.s_loc, pm.sites_size(mesh), bs, n_blocks_s)
            valid_rows = row2block >= 0

            def resum_true(M_true, X):
                """resum_blocks with the [.., n_blocks_s] weight matrix
                permuted into the concatenated row order."""
                Mr = np.zeros((M_true.shape[0], int(X.shape[0])),
                              np.float64)
                Mr[:, valid_rows] = M_true[:, row2block[valid_rows]]
                return np.asarray(
                    pm.resum_blocks(jnp.asarray(Mr, X.dtype), X, mesh),
                    np.float64)

            # rep 0 = sum of the real blocks + the truncation tail.
            ones = np.ones((1, n_blocks_s), np.float64)
            raw0 = resum_true(ones, B)[0]
            cnt0 = None
            if C is not None:
                cnt0 = resum_true(ones, C)[0]
            if S > n_trunc:
                tail_w = np.zeros((S,), np.float64)
                tail_w[n_trunc:] = 1.0
                # the tail (< one block) spans at most two (device,
                # round) cells, whose round indices are those of its
                # endpoints in the device-major layout
                tr = sorted({(t % stream.s_loc) // stream.chunk
                             for t in (n_trunc, S - 1)})
                for r in tr:
                    Pr = stream.round_data(r)
                    wr = stream.round_cols(r, tail_w)
                    raw_t, cnt_t, _, _ = pm.sharded_suffstats(
                        Pr, score, mesh, indep=True,
                        pairwise_del=pars.pairwise_del, site_weights=wr,
                        dtype=dtype, n_sites=int(Pr.shape[0]),
                    )
                    raw0 = raw0 + np.asarray(raw_t, np.float64)
                    if cnt0 is not None:
                        cnt0 = cnt0 + np.asarray(cnt_t, np.float64)
            if start_rep == 0:
                raw_m, cnt_m = to_matrix(raw0, cnt0)
                denom = cnt_m if pars.pairwise_del else float(S)
                yield _finalize(raw_m, denom, pars, on_stats)
            table = bt.block_index_table(pars.seed, n_reps, n_blocks_s)
            M_true = bt.block_multiplicity(table, n_blocks_s)
            raw_r = resum_true(M_true, B)
            cnt_r = None if C is None else resum_true(M_true, C)
            for r in range(n_reps):
                if r + 1 < start_rep:
                    continue
                raw_m, cnt_m = to_matrix(
                    raw_r[r], None if cnt_r is None else cnt_r[r])
                denom = cnt_m if pars.pairwise_del else float(n_trunc)
                yield _finalize(raw_m, denom, pars, on_stats)
            return

        for rep in range(start_rep, n_reps + 1):
            if rep == 0:
                w_full = np.ones((S,), np.float64)
                denom_sites = float(S)
            else:
                w_full = np.zeros((S,), np.float64)
                w_full[:n_trunc] = np.bincount(maps[rep - 1], minlength=n_trunc)
                denom_sites = float(n_trunc)
            raw, cnt = stats_rounds(w_full, rep)
            raw_m, cnt_m = to_matrix(raw, cnt)
            denom = cnt_m if pars.pairwise_del else denom_sites
            yield _finalize(raw_m, denom, pars, on_stats)
        return

    block_size = pars.boot_block_size
    n_blocks = n_trunc // block_size if n_reps else 0
    itemsize = 8 if dtype == jnp.float64 else 4
    partial_cells = N * N if pars.indep_geno else (N * N - N) // 2
    partial_bytes = n_blocks * partial_cells * itemsize * (2 if pars.pairwise_del else 1)
    # Block partials are 1-D-mesh only; a pairs axis takes the
    # weighted-recompute path (pm.sharded_suffstats rejects the combo).
    use_partials = (n_reps > 0 and partial_bytes <= PARTIALS_BUDGET_BYTES
                    and pm.pairs_size(mesh) == 1)

    B = C = None
    em_zb = None  # [n_blocks, N] zero-row flags for replicate poisoning
    if not pars.indep_geno and use_partials:
        # EM path: one sharded pass yields rep-0 stats AND block partials.
        raw, cnt, B, C = pm.sharded_suffstats(
            arr, score, mesh, indep=False, pairwise_del=pars.pairwise_del,
            n_blocks=n_blocks, block_size=block_size, dtype=dtype, n_sites=S,
            may_zero=not pars.in_bin,
        )
        if not pars.pairwise_del and not pars.in_bin:
            # the partials pass skips _em_local's zero-row poison so
            # unsampled blocks stay clean; recompute the flags here
            # from the sharded array (_em_zero_rows parity; binary
            # inputs cannot contain zero rows — skip the scan)
            zrow = np.asarray(jnp.all(arr == 0, axis=-1)[:S])  # [S, N]
            em_zb = zrow[:n_blocks * block_size].reshape(
                n_blocks, block_size, N).any(axis=1)
            z0 = zrow.any(axis=0)
            raw = np.asarray(raw, np.float64).copy()
            bad0 = (z0[I] | z0[J]) if raw.ndim == 1 else None
            if bad0 is not None:
                raw[bad0] = np.nan
        if start_rep == 0:
            raw_m, cnt_m = to_matrix(raw, None if not pars.pairwise_del else cnt)
            denom = cnt_m if pars.pairwise_del else float(S)
            yield _finalize(raw_m, denom, pars, on_stats)
    elif start_rep == 0:
        raw, cnt, _, _ = pm.sharded_suffstats(
            arr, score, mesh, indep=pars.indep_geno,
            pairwise_del=pars.pairwise_del, dtype=dtype, n_sites=S,
            may_zero=not pars.in_bin,
        )
        raw_m, cnt_m = to_matrix(raw, None if not pars.pairwise_del else cnt)
        denom = cnt_m if pars.pairwise_del else float(S)
        yield _finalize(raw_m, denom, pars, on_stats)

    if n_reps == 0 or start_rep > n_reps:
        return
    table = bt.block_index_table(pars.seed, n_reps, n_blocks)

    if use_partials:
        if pars.indep_geno:
            _, _, B, C = pm.sharded_suffstats(
                arr, score, mesh, indep=True, pairwise_del=pars.pairwise_del,
                n_blocks=n_blocks, block_size=block_size, dtype=dtype, n_sites=S,
                may_zero=not pars.in_bin,
            )
        raw_r, cnt_r = pm.bootstrap_replicates(table, B, C, n_blocks, mesh)
        mult = bt.block_multiplicity(table, n_blocks) if em_zb is not None \
            else None
        for r in range(n_reps):
            if r + 1 < start_rep:
                continue
            raw_rr = raw_r[r]
            if em_zb is not None:
                # replicate poisoned exactly where it SAMPLES a block
                # containing a zero row (_em_zero_rows parity)
                z = em_zb[mult[r] > 0].any(axis=0) if (mult[r] > 0).any() \
                    else np.zeros((N,), bool)
                bad = z[I] | z[J]
                if bad.any():
                    raw_rr = np.asarray(raw_rr, np.float64).copy()
                    raw_rr[bad] = np.nan
            raw_m, cnt_m = to_matrix(raw_rr, None if cnt_r is None else cnt_r[r])
            denom = cnt_m if pars.pairwise_del else float(n_trunc)
            yield _finalize(raw_m, denom, pars, on_stats)
    else:
        for r in range(n_reps):
            if r + 1 < start_rep:
                continue
            w = np.zeros((S,), np.float64)
            w[:n_trunc] = np.bincount(maps[r], minlength=n_trunc)
            raw, cnt, _, _ = pm.sharded_suffstats(
                arr, score, mesh, indep=pars.indep_geno,
                pairwise_del=pars.pairwise_del, site_weights=w, dtype=dtype,
                n_sites=S, may_zero=not pars.in_bin,
            )
            raw_m, cnt_m = to_matrix(raw, cnt)
            denom = cnt_m if pars.pairwise_del else float(n_trunc)
            yield _finalize(raw_m, denom, pars, on_stats)


# ------------------------------------------------------------------ #
# Extended evolutionary models (K80 / F81 / F84 / TN93)               #
# ------------------------------------------------------------------ #


def _iter_replicates_extended(
    pars: Params,
    P_host: np.ndarray,
    maps: List[np.ndarray],
    n_trunc: int,
    alleles,
    on_stats=None,
    mesh=None,
    start_rep: int = 0,
    round_ckpt: bool = False,
) -> Iterator[np.ndarray]:
    """Replicate stream for evol_model 3-6 (core/submodels.py).

    The expected-mismatch statistics are computed three times with
    disjoint site masks (A<->G transitions, C<->T transitions,
    transversions); unclassifiable sites are excluded entirely.
    Bootstrap replicates take the weighted-recompute path (the masks
    fold into the per-site multiplicities).

    With a mesh, every contraction shards over the 'sites' axis —
    class-masked sufficient statistics via pm.sharded_suffstats and
    base frequencies via pm.sharded_pair_pi — so models 3-6 scale out
    exactly like models 0-2 (including multi-host prebuilt arrays).
    """
    from . import submodels as sm

    if alleles is None:
        raise ValueError("extended evolutionary models need allele codes")
    a1, a2 = alleles
    masks = sm.classify_sites(a1, a2)
    need_pi = pars.evol_model >= 4

    if mesh is not None:
        yield from _extended_mesh(
            pars, P_host, maps, n_trunc, a1, a2, masks, need_pi, on_stats,
            mesh, start_rep=start_rep, round_ckpt=round_ckpt,
        )
        return

    dtype = default_dtype()
    N = pars.n_ind
    S = pars.n_sites
    score = jnp.asarray(pars.score, dtype)
    score9 = score.reshape(-1)
    I, J = _pair_indices(N)

    # Long genomes: stream site chunks like the model 0-2 path does.
    itemsize = np.dtype(np.float64 if dtype == jnp.float64 else np.float32).itemsize
    budget = _device_budget_bytes()
    chunked = S * N * 3 * itemsize > budget
    chunk = _stream_chunk_sites(S, N, itemsize, budget) if chunked else S
    P = None if chunked else put_probs(P_host, dtype,
                                       may_zero=not pars.in_bin)

    if pars.pairwise_del:
        # host-side miss_data (keeps chunk streaming device-free here)
        Ph = np.asarray(P_host)
        d01 = np.abs(Ph[..., 0] - Ph[..., 1])
        d12 = np.abs(Ph[..., 1] - Ph[..., 2])
        valid_h = (~((d01 < EPSILON) & (d12 < EPSILON))).astype(np.float64)
    else:
        valid_h = None
    bc = sm.expected_base_counts(np.asarray(P_host, np.float64), a1, a2) if need_pi else None

    def _class_stats_one(Psub, w: np.ndarray):
        # Weights (class masks x replicate multiplicities) stream in as
        # per-site vectors, so every (chunk, class, replicate)
        # combination reuses one compiled shape per chunk length.
        if pars.indep_geno:
            raw, cnt = indep_suffstats(
                Psub, score, pars.pairwise_del, jnp.asarray(w, dtype)
            )
            return np.asarray(raw, np.float64), (
                None if cnt is None else np.asarray(cnt, np.float64)
            )
        raw, cnt = em_pair_stats(Psub, score9, pars.pairwise_del,
                                 site_weights=w)
        rawv = np.asarray(raw, np.float64)
        cntv = np.asarray(cnt, np.float64)
        return (
            _scatter_pairs(rawv, I, J, N),
            _scatter_pairs(cntv, I, J, N),
        )

    CLS = ("ag", "ct", "tv")

    def all_class_stats(w: np.ndarray, rep: int):
        """{class: (raw, cnt)} for site weights w.  Chunked runs upload
        each chunk ONCE and reduce all three class masks against it,
        checkpointing the six accumulators after every chunk round
        (round_ckpt) so a kill mid-replicate loses at most one round."""
        if not chunked:
            return {cl: _class_stats_one(P, w * masks[cl]) for cl in CLS}
        accs = {cl: [None, None] for cl in CLS}
        skip = 0
        if round_ckpt:
            from ..utils import checkpoint as ckpt_mod

            got = ckpt_mod.load_rounds(pars.out, pars, rep, engine="jax")
            if got is not None:
                skip, arrs = got
                for cl in CLS:
                    accs[cl][0] = arrs[f"raw_{cl}"]
                    accs[cl][1] = arrs.get(f"cnt_{cl}")
        # Two-stage staging: host pack on one thread, the device link
        # on another (_pipelined_chunks — see stats_stream).
        def read_ext(rng_):
            return (_host_pack(P_host[slice(*rng_)], dtype,
                               may_zero=not pars.in_bin), rng_)

        def send_ext(item):
            arr, rng_ = item
            return _send_probs(arr), rng_

        ranges = [(s, min(s + chunk, S)) for s in range(0, S, chunk)][skip:]
        idx = skip
        for Pc, (start, stop) in _pipelined_chunks(ranges, read_ext, send_ext):
            for cl in CLS:
                r, c = _class_stats_one(Pc, (w * masks[cl])[start:stop])
                accs[cl][0] = r if accs[cl][0] is None else accs[cl][0] + r
                if c is not None:
                    accs[cl][1] = c if accs[cl][1] is None else accs[cl][1] + c
            idx += 1
            if round_ckpt:
                from ..utils import checkpoint as ckpt_mod

                arrs = {}
                for cl in CLS:
                    arrs[f"raw_{cl}"] = accs[cl][0]
                    if accs[cl][1] is not None:
                        arrs[f"cnt_{cl}"] = accs[cl][1]
                ckpt_mod.save_rounds(pars.out, pars, rep, idx, arrs, engine="jax")
        return {cl: (accs[cl][0], accs[cl][1]) for cl in CLS}

    def pair_pi(w_ok: np.ndarray):
        """[N, N, 4] per-pair base frequencies over classifiable sites."""
        if pars.pairwise_del:
            vw = valid_h * w_ok[:, None]
            U = np.einsum("six,sj->ijx", bc * vw[:, :, None], valid_h)
            tot = U + np.transpose(U, (1, 0, 2))
        else:
            c = np.einsum("s,six->ix", w_ok, bc)  # [N, 4]
            tot = c[:, None, :] + c[None, :, :]
        denom = np.sum(tot, axis=-1, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            return tot / denom

    def one_matrix(w: np.ndarray, denom_sites: float, rep: int):
        stats = all_class_stats(w, rep)
        raws = {cl: stats[cl][0] for cl in CLS}
        cnts = {cl: stats[cl][1] for cl in CLS}
        if pars.pairwise_del:
            true_cnt = cnts["ag"] + cnts["ct"] + cnts["tv"]
        else:
            true_cnt = denom_sites
        cnt = float(pars.tot_sites) if pars.tot_sites > 0 else true_cnt
        pi = pair_pi(w * masks["ok"]) if need_pi else None
        if on_stats is not None:
            on_stats(raws["ag"] + raws["ct"] + raws["tv"], true_cnt)
        d = sm.apply_extended_model(
            pars.evol_model, raws["ag"], raws["ct"], raws["tv"], cnt, pi
        )
        np.fill_diagonal(d, 0.0)
        return d

    if start_rep == 0:
        w_full = np.ones((S,), np.float64)
        yield one_matrix(w_full, float(np.sum(masks["ok"])), 0)

    for r in range(pars.n_boot_rep):
        if r + 1 < start_rep:
            continue
        w = np.zeros((S,), np.float64)
        w[:n_trunc] = np.bincount(maps[r], minlength=n_trunc)
        yield one_matrix(w, float(np.sum(w * masks["ok"])), r + 1)


def _extended_mesh(
    pars: Params,
    P_host,
    maps: List[np.ndarray],
    n_trunc: int,
    a1: np.ndarray,
    a2: np.ndarray,
    masks,
    need_pi: bool,
    on_stats,
    mesh,
    start_rep: int = 0,
    round_ckpt: bool = False,
) -> Iterator[np.ndarray]:
    """Mesh-sharded replicate stream for evol_model 3-6.

    P_host: numpy [S, N, 3], a SiteStream, or a prebuilt padded global
    jax.Array.  Over-budget genomes iterate fixed-shape site rounds
    (SiteStream): the class-masked statistics AND the base-frequency
    counts are both additive over sites, so each is accumulated across
    rounds and combined exactly as in the resident path."""
    import jax

    from . import submodels as sm
    from ..parallel import mesh as pm

    dtype = default_dtype()
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32
    N = pars.n_ind
    S = pars.n_sites
    score = pars.score
    I, J = _pair_indices(N)

    stream = _as_stream(pars, P_host, mesh)
    streaming = stream is not None and not stream.resident
    if stream is None:
        Pp = P_host          # legacy prebuilt resident array
    elif not streaming:
        Pp = stream.global_array()
    else:
        Pp = None
    A1h = A2h = None
    if need_pi:
        A1h, A2h = pm.allele_onehots(a1, a2, np_dtype)

    def suffstats_one(Parr, w, n_sites):
        raw, cnt, _, _ = pm.sharded_suffstats(
            Parr, score, mesh, indep=pars.indep_geno,
            pairwise_del=pars.pairwise_del, site_weights=w, dtype=dtype,
            may_zero=not pars.in_bin,
            n_sites=n_sites,
        )
        raw = np.asarray(raw, np.float64)
        if raw.ndim == 1:  # EM pair-vector
            return (
                _scatter_pairs(raw, I, J, N),
                _scatter_pairs(np.asarray(cnt, np.float64), I, J, N),
            )
        return raw, None if cnt is None else np.asarray(cnt, np.float64)

    CLS = ("ag", "ct", "tv")
    has_cnt = pars.pairwise_del or not pars.indep_geno

    def _ckpt_shapes():
        shapes = {f"raw_{cl}": (N, N) for cl in CLS}
        if has_cnt:
            shapes.update({f"cnt_{cl}": (N, N) for cl in CLS})
        if need_pi:
            shapes["pi"] = (N, N, 4) if pars.pairwise_del else (N, 4)
        return shapes

    def all_stats(w: np.ndarray, rep: int):
        """({class: (raw, cnt)}, pi) for site weights w.  Streaming
        uploads each round's data ONCE and reduces all three class
        masks plus the base-frequency counts against it; the seven
        accumulators round-checkpoint on process 0 (broadcast resume
        keeps the collective stream aligned across processes)."""
        w_ok = w * masks["ok"] if need_pi else None
        if not streaming:
            stats = {cl: suffstats_one(Pp, w * masks[cl], S) for cl in CLS}
            pi = pm.sharded_pair_pi(
                Pp, a1, a2, w_ok, mesh,
                pairwise_del=pars.pairwise_del, dtype=dtype, n_sites=S,
                may_zero=not pars.in_bin,
            ) if need_pi else None
            return stats, pi
        skip, arrs = _round_ckpt_resume(pars, rep, _ckpt_shapes(), round_ckpt)
        accs = {cl: [None, None] for cl in CLS}
        pi_acc = None
        if arrs is not None:
            for cl in CLS:
                accs[cl][0] = arrs[f"raw_{cl}"]
                accs[cl][1] = arrs.get(f"cnt_{cl}")
            pi_acc = arrs.get("pi")
        rounds = list(range(skip, stream.n_rounds))
        # one-round lookahead (see stats_rounds): stage round r+1 while
        # round r's class reductions are in flight
        pending = stream.round_data(rounds[0]) if rounds else None
        for k, r in enumerate(rounds):
            Pr = pending
            if k + 1 < len(rounds):
                pending = stream.round_data(rounds[k + 1])
            for cl in CLS:
                rr, cc = suffstats_one(
                    Pr, stream.round_cols(r, w * masks[cl]),
                    stream.round_sites,
                )
                accs[cl][0] = rr if accs[cl][0] is None else accs[cl][0] + rr
                if cc is not None:
                    accs[cl][1] = cc if accs[cl][1] is None else accs[cl][1] + cc
            if need_pi:
                c = pm.pair_pi_counts(
                    Pr, stream.round_cols(r, A1h), stream.round_cols(r, A2h),
                    stream.round_cols(r, w_ok), mesh,
                    pairwise_del=pars.pairwise_del,
                )
                pi_acc = c if pi_acc is None else pi_acc + c
            if round_ckpt and jax.process_index() == 0:
                from ..utils import checkpoint as ckpt_mod

                out = {}
                for cl in CLS:
                    out[f"raw_{cl}"] = accs[cl][0]
                    if accs[cl][1] is not None:
                        out[f"cnt_{cl}"] = accs[cl][1]
                if pi_acc is not None:
                    out["pi"] = pi_acc
                ckpt_mod.save_rounds(pars.out, pars, rep, r + 1, out, engine="jax")
        pi = (pm.normalize_pair_pi(pi_acc, pars.pairwise_del)
              if need_pi else None)
        return {cl: (accs[cl][0], accs[cl][1]) for cl in CLS}, pi

    def one_matrix(w: np.ndarray, denom_sites: float, rep: int):
        stats, pi = all_stats(w, rep)
        raws = {cl: stats[cl][0] for cl in CLS}
        cnts = {cl: stats[cl][1] for cl in CLS}
        if pars.pairwise_del:
            true_cnt = cnts["ag"] + cnts["ct"] + cnts["tv"]
        else:
            true_cnt = denom_sites
        cnt = float(pars.tot_sites) if pars.tot_sites > 0 else true_cnt
        if on_stats is not None:
            on_stats(raws["ag"] + raws["ct"] + raws["tv"], true_cnt)
        d = sm.apply_extended_model(
            pars.evol_model, raws["ag"], raws["ct"], raws["tv"], cnt, pi
        )
        np.fill_diagonal(d, 0.0)
        return d

    if start_rep == 0:
        w_full = np.ones((S,), np.float64)
        yield one_matrix(w_full, float(np.sum(masks["ok"])), 0)

    for r in range(pars.n_boot_rep):
        if r + 1 < start_rep:
            continue
        w = np.zeros((S,), np.float64)
        w[:n_trunc] = np.bincount(maps[r], minlength=n_trunc)
        yield one_matrix(w, float(np.sum(w * masks["ok"])), r + 1)
