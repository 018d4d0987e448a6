"""Host-memory helpers for large tensor staging.

The first write to each page of a fresh allocation pays a page fault;
on para-virtualized kernels (sandboxed VMs) faults run at ~10 MB/s per
thread, so serially converting a multi-hundred-MB f64 tensor to f32
costs tens of seconds before any bytes move to the device.  Threaded
slice copies parallelize both the cast arithmetic (bandwidth-bound on
bare metal) and the first touch (fault-bound on VMs) — numpy releases
the GIL for large contiguous casts.
"""

from __future__ import annotations

import os
import threading

import numpy as np

_MIN_PARALLEL_BYTES = 1 << 25  # 32 MB: below this, thread spawn dominates


def parallel_astype(a: np.ndarray, dtype, max_threads: int = 16) -> np.ndarray:
    """`a.astype(dtype)` with threaded first-touch + cast.

    Returns `a` unchanged when it already has the target dtype (same
    semantics as np.asarray(a, dtype) — callers must not mutate).
    """
    dtype = np.dtype(dtype)
    if a.dtype == dtype:
        return a
    nt = min(max_threads, os.cpu_count() or 1)
    if a.nbytes < _MIN_PARALLEL_BYTES or nt == 1 or a.ndim == 0:
        return a.astype(dtype)
    # Workers read `a` directly (numpy block assignment handles strided
    # views) — a contiguity pre-pass here would serialize exactly the
    # first-touch gather this function exists to parallelize (the
    # upload23 path casts a [:, :, :2] view of the f64 tensor).
    src = a
    out = np.empty(src.shape, dtype)
    n = src.shape[0]
    nt = min(nt, n)
    bounds = [(w * n) // nt for w in range(nt + 1)]

    def worker(w: int) -> None:
        lo, hi = bounds[w], bounds[w + 1]
        out[lo:hi] = src[lo:hi]

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(nt)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def upload23_enabled(dtype) -> bool:
    """Whether host->device probability uploads drop the third genotype
    component.  The reader normalizes every triple to sum 1
    (read_data.cpp:40,98 post_prob; one-hot/uniform triples are exact),
    so p2 = 1 - p0 - p1 reconstructs on device within ~1e-7 relative —
    two orders below the EPSILON=1e-5 missing-data tolerance — for 1.5x
    fewer bytes over the host link.  auto = f32 only: x64 runs carry the md5 bit-parity
    contract and upload all three components.  NGSDIST_UPLOAD23=0/1
    forces."""
    mode = os.environ.get("NGSDIST_UPLOAD23", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return np.dtype(dtype) == np.float32


# Sentinel in the p0 column of 2-component upload slabs for rows that
# must expand back to the ALL-ZERO triple (a probability can never
# exceed 1, so p0 = PAD23 is unambiguous): padding rows, and data-borne
# (0,0,0) triples — text genomes consume empty lines as missing sites
# whose -BIGNEG log prefill exp()s to (0,0,0), which is otherwise
# indistinguishable from a hard-called (0,0,1) once p2 is dropped.
# All-zero triples matter twice: missing_mask classifies them missing
# (all components within EPSILON), and unweighted reductions (streamed
# block partials) rely on padded rows being inert.
PAD23 = 2.0

# uint16 fixed-point upload lane (NGSDIST_UPLOAD16): probabilities
# quantize to q = rint(p * U16_ONE) with q = PAD16 (= 65535) reserved
# as the row sentinel.  The scale is 65534 — NOT 65535 — for two load-
# bearing reasons: it frees the sentinel code, and it makes the
# device-side missing test (missing_mask: |p0-p1| < 1e-5 and
# |p1-p2| < 1e-5, EPSILON gen_func.hpp:16) EXACT on the grid.  One
# quantization step is 1/65534 = 1.526e-5 > EPSILON, so |r0-r1| < eps
# iff q0 == q1, and |r1 - (1-r0-r1)| < eps iff q0 + 2*q1 == 65534;
# combined they require 3*q0 == 65534, which has no integer solution
# (65534 = 2 mod 3).  Hence NO quantized data triple can ever be
# classified missing on device — missingness is decided on the host at
# full f64 precision (the exact engine's decision) and carried
# exclusively by the sentinel.
#
# The sentinel is VALUE-PRESERVING, (PAD16, q) -> the uniform triple
# (v, v, v) with v = q/65534: in the non-pairwise-deletion mode the
# reference USES missing triples' values (a uniform prior contributes
# its score expectation to the unmasked sum, ngsDist.cpp:333-364 via
# the soft probabilities), so a sentinel that zeroed them shifted
# distances by ~3e-3 at 5% missing.  q is the
# quantized MEAN of the three components — exactly-uniform triples
# (the only missing kind binary/normalized inputs produce) land on
# rint(65534/3) with ~5e-6 value error, inside the lane's
# quantization class.  Special q values: 0 -> the all-zero triple
# (pad tails and data-borne empty-line zeros fall out naturally:
# mean 0); PAD16 -> the all-NaN triple (literal-nan text rows must
# keep poisoning results).  Expanded sentinel rows are all-equal, so
# the device missing test classifies them missing — exactly the
# host's f64 decision.
U16_ONE = 65534
PAD16 = 65535
_MISS_EPS = 1e-5  # EPSILON (core.distance.EPSILON, gen_func.hpp:16)


def upload16_enabled(dtype) -> bool:
    """True when 2-component uploads should quantize to uint16 fixed
    point — 4 bytes/triple over the host link instead of pack23's 8.
    Accuracy: the quantization error (half-step 7.6e-6 per component)
    averages over the site axis inside raw/cnt, so measured distance
    deltas vs the f32 pack23 route are ~8e-7 at S=4k-65k — below the
    f32 engine's own error vs f64.  f32 engines only, even when forced:
    the x64 md5 contract and the f64 accumulation class both exclude a
    quantized upload even when forced.  auto: ON for device backends
    (where the host link is the floor the lane exists to halve), OFF
    on the cpu backend
    (where there is no link and the f32 lane keeps CPU f32 runs in
    lockstep with the golden tolerances).  NGSDIST_UPLOAD16=0/1
    forces.  The master switch for ANY 2-component upload remains
    upload23_enabled; this picks the lane width."""
    if np.dtype(dtype) != np.float32:
        return False
    if not upload23_enabled(dtype):
        # the uint16 lane is only reachable through the 2-component
        # path; NGSDIST_UPLOAD23=0 disables both (keeps byte-accounting
        # consumers like bench._bytes_per_triple honest too)
        return False
    mode = os.environ.get("NGSDIST_UPLOAD16", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    import jax

    return jax.default_backend() != "cpu"


def pack16(P3: np.ndarray, n_rows: int | None = None,
           max_threads: int = 16) -> np.ndarray:
    """Quantize a [S, ..., 3] normal-space probability tensor into the
    uint16 2-component upload slab [n_rows, ..., 2] (one threaded
    pass: quantize + missing scan + pad).  See the U16_ONE note for
    the sentinel/accuracy contract; hostmem.pack23 routes here when
    upload16_enabled, so every 2-component call site (chunk loops,
    mesh shards, SiteStream rounds, multihost locals) inherits the
    lane without new routing."""
    S = P3.shape[0]
    rows = S if n_rows is None else n_rows
    out = np.empty((rows,) + P3.shape[1:-1] + (2,), np.uint16)

    def block(lo: int, hi: int) -> None:
        cp = min(hi, S)
        if lo < cp:
            b = P3[lo:cp]
            blk = out[lo:cp]
            with np.errstate(invalid="ignore"):  # NaN rows sentinel below
                np.copyto(blk, np.rint(b[..., :2] * U16_ONE),
                          casting="unsafe")
            # host-side miss_data at source precision (gen_func.cpp:
            # 862-868): sentinel these rows with their quantized mean
            # (value-preserving, see the U16_ONE note) — the grid
            # arithmetic guarantees no other row tests missing on device
            miss = (np.abs(b[..., 0] - b[..., 1]) < _MISS_EPS) \
                & (np.abs(b[..., 1] - b[..., 2]) < _MISS_EPS)
            if miss.any():
                m = (b[..., 0] + b[..., 1] + b[..., 2])[miss] / 3.0
                blk[..., 0][miss] = PAD16
                blk[..., 1][miss] = np.rint(m * U16_ONE).astype(np.uint16)
            nan = np.isnan(b[..., 0]) | np.isnan(b[..., 1]) \
                | np.isnan(b[..., 2])
            if nan.any():
                blk[..., 0][nan] = PAD16
                blk[..., 1][nan] = PAD16
        if cp < hi:
            pad = out[max(lo, S):hi]
            pad[...] = 0
            pad[..., 0] = PAD16

    nt = min(max_threads, os.cpu_count() or 1, max(1, rows))
    if P3.nbytes < _MIN_PARALLEL_BYTES or nt == 1:
        block(0, rows)
        return out
    bounds = [(w * rows) // nt for w in range(nt + 1)]
    ts = [threading.Thread(target=block, args=(bounds[w], bounds[w + 1]))
          for w in range(nt)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def pack23(P3: np.ndarray, dtype, n_rows: int | None = None,
           max_threads: int = 16, may_zero: bool = True) -> np.ndarray:
    """Pack a [S, ..., 3] normal-space probability tensor into the
    2-component upload slab [n_rows, ..., 2] (ONE threaded pass:
    cast + pad + sentinel scan), with the PAD23 sentinel on every row
    the device-side expansion must restore to all-zero: the pad tail
    (n_rows > S) and data-borne all-zero triples.  The zero-triple
    scan runs inside the cast workers on the just-written (cache-hot)
    block — a separate serial pass measured ~4.6 s at 64k x 1k.

    may_zero=False skips the scan (~30%% of the pack cost): all-zero
    triples exist ONLY in text-read genomes (the -BIGNEG prefill of
    empty-line missing sites) — every parsed row log-normalizes to
    sum 1, so binary inputs cannot produce one (callers pass
    `not pars.in_bin`).  See upload23_enabled for when callers pack.

    When upload16_enabled(dtype), the slab is uint16 fixed point
    instead (pack16) — half the bytes again; expand23 dispatches on
    the slab dtype, so call sites are oblivious.  pack16 always runs
    its missing scan (which subsumes the zero-triple scan: an all-zero
    triple is all-equal), so may_zero is moot there."""
    dtype = np.dtype(dtype)
    if upload16_enabled(dtype):
        return pack16(P3, n_rows, max_threads)
    S = P3.shape[0]
    rows = S if n_rows is None else n_rows
    out = np.empty((rows,) + P3.shape[1:-1] + (2,), dtype)

    def block(lo: int, hi: int) -> None:
        cp = min(hi, S)
        if lo < cp:
            blk = out[lo:cp]
            blk[...] = P3[lo:cp, ..., :2]
            if may_zero:
                # candidate mask on the SOURCE dtype (cache-hot from
                # the cast just above), not the cast block: an f64
                # triple with sub-f32-denormal p0/p1 casts to 0.0f and
                # would be falsely sentineled by an f32-side scan.
                # Confirm against the dropped component only when
                # candidates exist ((0,0,*): p2 one-hots, empty-lines)
                zz = (P3[lo:cp, ..., 0] == 0) & (P3[lo:cp, ..., 1] == 0)
                if zz.any():
                    np.logical_and(zz, P3[lo:cp, ..., 2] == 0, out=zz)
                    blk[..., 0][zz] = PAD23
        if cp < hi:
            pad = out[max(lo, S):hi]
            pad[...] = 0
            pad[..., 0] = PAD23

    nt = min(max_threads, os.cpu_count() or 1, max(1, rows))
    if P3.nbytes < _MIN_PARALLEL_BYTES or nt == 1:
        block(0, rows)
        return out
    bounds = [(w * rows) // nt for w in range(nt + 1)]
    ts = [threading.Thread(target=block, args=(bounds[w], bounds[w + 1]))
          for w in range(nt)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def parallel_cast_pad(a: np.ndarray, dtype, n_rows: int,
                      max_threads: int = 16) -> np.ndarray:
    """Cast to dtype and zero-pad axis 0 to n_rows in ONE threaded pass
    (cast-then-pad would allocate and first-touch the tensor twice).

    Returns `a` unchanged when no cast and no pad is needed (callers
    must not mutate the result).
    """
    dtype = np.dtype(dtype)
    S = a.shape[0]
    if n_rows == S and a.dtype == dtype:
        return a
    nt = min(max_threads, os.cpu_count() or 1)
    out = np.empty((n_rows,) + a.shape[1:], dtype)
    if a.nbytes < _MIN_PARALLEL_BYTES or nt == 1:
        out[:S] = a
        out[S:] = 0
        return out
    # Strided views are read directly by the workers (see parallel_astype).
    src = a
    nt = min(nt, n_rows)
    bounds = [(w * n_rows) // nt for w in range(nt + 1)]

    def worker(w: int) -> None:
        lo, hi = bounds[w], bounds[w + 1]
        cp = min(hi, S)
        if lo < cp:
            out[lo:cp] = src[lo:cp]
        if cp < hi:
            out[max(lo, S):hi] = 0

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(nt)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def coded_upload_enabled(dtype) -> bool:
    """Whether fully-coded probability tensors (every triple one-hot or
    a uniform missing value — hard-genotype inputs, read_data.cpp:87-95,
    and default-threshold --call_geno runs, gen_func.cpp:886-914) are
    uploaded as ONE uint8 code per (site, individual) plus a tiny
    lookup table, expanded on device.  8x fewer host-link bytes than
    the packed f32 slab — and bit-faithful: the table rows ARE the f32
    casts of the f64 triples the staged pipeline would upload (one-hot
    rows are exact; the uniform value avoids even pack23's ~1e-7 p2
    reconstruction).  auto = f32 only (x64 runs carry the md5 parity
    contract and upload full f64); NGSDIST_CODED_UPLOAD=0/1 forces."""
    mode = os.environ.get("NGSDIST_CODED_UPLOAD", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return np.dtype(dtype) == np.float32


# Codes 0-2 = one-hot genotype; 3+ = uniform missing triples (distinct
# values get distinct table rows: the reader's exp(log(1/3)) uniform
# and the all-zero empty-line triple can coexist in one text genome).
_CODED_MAX_UNIFORM = 4


def derive_codes(P3: np.ndarray, chunk_rows: int = 1 << 21):
    """(codes uint8 [S, N], lut f32 [3 + u, 3]) when EVERY triple in the
    [S, N, 3] normal-space tensor is an exact one-hot or one of at most
    _CODED_MAX_UNIFORM all-equal values; None otherwise (first
    non-codeable chunk bails).  The scan is chunked so its boolean
    temporaries stay bounded on multi-GB tensors."""
    S, N = P3.shape[0], P3.shape[1]
    flat = P3.reshape(-1, 3)
    # Pre-sample a few spread-out row blocks before the full pass: a
    # large non-codeable tensor whose FIRST chunks happen to be
    # codeable would otherwise pay a multi-GB scan for nothing
    # (ADVICE r04).  Soft-GP triples fail the probe immediately.
    probe = 1 << 12
    if flat.shape[0] > 4 * chunk_rows:
        for frac in (0.5, 0.99):
            lo = int(flat.shape[0] * frac) // N * N
            b = flat[lo:lo + probe]
            miss = (b[:, 0] == b[:, 1]) & (b[:, 1] == b[:, 2])
            hot = (np.max(b, axis=1) == 1.0) & ((b != 0).sum(axis=1) == 1)
            if not np.all(miss | hot):
                return None
    codes = np.empty(flat.shape[0], np.uint8)
    uniform_vals: list = []
    for lo in range(0, flat.shape[0], chunk_rows):
        b = flat[lo:lo + chunk_rows]
        p0, p1, p2 = b[:, 0], b[:, 1], b[:, 2]
        miss = (p0 == p1) & (p1 == p2)
        am = np.argmax(b, axis=1).astype(np.uint8)
        # one-hot exactness: the max component is 1 and the others 0
        rows = np.arange(b.shape[0])
        hot = (b[rows, am] == 1.0) & ((b != 0).sum(axis=1) == 1)
        if not np.all(miss | hot):
            return None
        c = am
        if miss.any():
            mv = p0[miss]
            for v in np.unique(mv):
                if v not in uniform_vals:
                    uniform_vals.append(float(v))
                    if len(uniform_vals) > _CODED_MAX_UNIFORM:
                        return None
            # map each missing triple to its uniform-value slot
            idx = np.empty(mv.shape[0], np.uint8)
            for k, v in enumerate(uniform_vals):
                idx[mv == v] = 3 + k
            c = c.copy()
            c[miss] = idx
        codes[lo:lo + chunk_rows] = c
    # The table keeps the exact f64 host values; the pack stage casts
    # to the engine dtype, so expansion == the cast of the f64 triple.
    lut = np.zeros((3 + max(1, len(uniform_vals)), 3), np.float64)
    lut[0, 0] = lut[1, 1] = lut[2, 2] = 1.0
    for k, v in enumerate(uniform_vals):
        lut[3 + k, :] = v
    return codes.reshape(S, N), lut


def coded_call_lut(any_missing: bool) -> np.ndarray:
    """The fixed lookup table for default-threshold call_geno codes
    (readers.read_geno_codes): rows 0-2 exact one-hot (exp(0)=1,
    exp(-BIGNEG)=0), row 3 the uniform exp(log(1/3)) missing triple —
    zeroed when no missing triple occurred, so the table is bit-
    identical to what derive_codes would have captured from the staged
    tensor (its lut carries only the uniform values that OCCUR; the
    placeholder row is zero)."""
    lut = np.zeros((4, 3), np.float64)
    lut[0, 0] = lut[1, 1] = lut[2, 2] = 1.0
    if any_missing:
        lut[3, :] = np.exp(np.log(1.0 / 3.0))
    return lut


def coded_pad_lut(lut: np.ndarray):
    """(lut, pad_code) for sharded/padded coded uploads: pad rows must
    expand to the ALL-ZERO triple (inert in unweighted mesh reductions,
    exactly like the PAD23 sentinel).  Reuses an existing all-zero lut
    row (empty-line text sites) or appends one."""
    zero = np.where(~lut.any(axis=1))[0]
    if zero.size:
        return lut, int(zero[0])
    return np.vstack([lut, np.zeros((1, 3), lut.dtype)]), int(lut.shape[0])


class CodedSlab:
    """Host-prepped upload unit for a coded tensor: the uint8 code
    plane slice plus the shared lookup table (distance._send_probs
    ships it and expands on device)."""

    __slots__ = ("codes", "lut")

    def __init__(self, codes: np.ndarray, lut: np.ndarray) -> None:
        self.codes = codes
        self.lut = lut


class CodedProbs:
    """A [S, N, 3] probability tensor whose triples are all one-hot /
    uniform, carrying the uint8 code plane for 1-byte device uploads
    (derive_codes).  Quacks like the ndarray for the host-side
    consumers the jax engine path has (slicing, np.asarray, shape);
    distance._host_pack recognizes it and stages CodedSlab uploads.

    P may be None (the fused read_geno_codes path never materializes
    the f64 tensor): the .P property reconstructs it on demand from
    codes + lut — bit-exact, since the lut rows ARE the triples the
    staged pipeline would have produced — so rarely-taken fallbacks
    (coded uploads disabled mid-flight, fancy indexing) still work at
    a one-time 24-bytes/triple cost."""

    def __init__(self, P, codes: np.ndarray, lut: np.ndarray) -> None:
        self._P = P
        self.codes = codes
        self.lut = lut

    @property
    def P(self) -> np.ndarray:
        if self._P is None:
            self._P = np.take(self.lut, self.codes.reshape(-1), axis=0
                              ).reshape(self.codes.shape + (3,))
        return self._P

    @property
    def shape(self):
        return self.codes.shape + (3,)

    @property
    def dtype(self):
        return self.lut.dtype

    def __len__(self):
        return len(self.codes)

    def __array__(self, dtype=None, copy=None):
        # copy=True must not hand back the cached self._P: a caller
        # mutating the "copy" would corrupt the tensor shared with
        # later fallback paths (ADVICE r04).
        if copy:
            return np.array(self.P, dtype=dtype, copy=True)
        return np.asarray(self.P, dtype)

    def __getitem__(self, key):
        # site-axis slices keep the code plane (the streamed loops cut
        # [start:stop] chunks); anything fancier decays to the tensor
        if isinstance(key, slice):
            return CodedProbs(None if self._P is None else self._P[key],
                              self.codes[key], self.lut)
        return self.P[key]
