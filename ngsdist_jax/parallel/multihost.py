"""Multi-host orchestration: per-host shard reading + global sharded arrays.

The reference is strictly single-node (SURVEY.md §2.3).  Here, N hosts
each read their own contiguous site range of the genotype file
(io/readers.py site_range), assemble the global [n_sites, n_ind, 3]
array from process-local shards, and run the mesh engine
(parallel/mesh.py) whose psum merges partial statistics across devices
and hosts.

Single-process meshes take the same path (the local shard is simply the
whole site axis), so this module is exercised by the test suite without
multiple processes; `bring_up` wires `jax.distributed.initialize` for
real multi-host runs.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Params
from ..core.preprocess import preprocess
from ..io import readers
from ..utils.hostmem import (PAD16, PAD23, CodedProbs, coded_call_lut,
                             coded_pad_lut, coded_upload_enabled, pack23,
                             parallel_cast_pad, upload16_enabled,
                             upload23_enabled)
from .mesh import AXIS, _round_up


# XLA splits GPU autotuning among the processes of a run and swaps the
# results.  On H100s, --coordinator runs of the indep path (two matmul
# fusions per module, four processes) lost the two processes left
# without a share to SIGSEGV, while EM runs (no matmuls) were fine; each
# process autotunes its own programs instead.
SHARD_AUTOTUNING_OFF = "--xla_gpu_shard_autotuning=false"


def bring_up(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Initialize the multi-host runtime (no-op if already initialized
    or single-process with no coordinator given).

    local_device_ids binds this process to those local devices.  With
    several processes on one host (one per card), each must name its
    own card: left unset, every process claims all of them, and the
    second process to reserve device memory runs out."""
    if coordinator_address is None:
        return
    # read when the backend starts, which is after this point
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_gpu_shard_autotuning" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {SHARD_AUTOTUNING_OFF}".strip()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=(None if local_device_ids is None
                          else list(local_device_ids)),
    )


def _classify_call_rows(rows: np.ndarray) -> np.ndarray:
    """Default-threshold call_geno codes for LOG-NORMALIZED rows
    [.., 3]: one-hot at the FIRST argmax (np.argmax first-max == the
    strict-> scan of nd_call_geno3), exactly all-equal rows missing
    (code 3 -> exp(log(1/3)) lut row), all-NaN rows (literal-nan text
    fields; normalize infects the whole row) code 4 -> NaN lut row.
    Applied to stored values as-is — NO re-normalize, which could flip
    exact argmax ties."""
    am = np.argmax(rows, axis=-1).astype(np.uint8)
    all_eq = ((rows[..., 0] == rows[..., 1])
              & (rows[..., 1] == rows[..., 2]))
    codes = np.where(all_eq, np.uint8(3), am)
    nan_rows = np.isnan(rows[..., 0])
    if nan_rows.any():
        codes = np.where(nan_rows, np.uint8(4), codes)
    return codes


def _call_lut_padded() -> Tuple[np.ndarray, int]:
    """The STATIC (lut, pad_code) every coded from_reader stream uses:
    one-hot rows, exp(log(1/3)) missing, NaN (text literal-nan), and
    the appended all-zero pad row — decided before any data is read,
    identically on every process (no broadcast)."""
    lut = np.vstack([coded_call_lut(True), np.full((1, 3), np.nan)])
    return coded_pad_lut(lut)


def host_site_range(n_sites_pad: int, mesh: Mesh) -> Tuple[int, int]:
    """This process's contiguous site range under the mesh's sites axis.

    The padded site count divides evenly over devices; a host owns the
    union of its local devices' shards, which is contiguous for a 1-D
    mesh enumerated in process order.  A mesh whose process's devices
    are NOT contiguous in the axis order would silently compute a
    too-wide range (and fail later with an opaque shape error), so it
    is rejected here explicitly.
    """
    if jax.process_count() == 1:
        return 0, n_sites_pad
    from .mesh import pairs_size, sites_size

    if pairs_size(mesh) > 1:
        raise ValueError(
            "multi-process runs support 1-D 'sites' meshes only (a pairs "
            "axis would need per-host replica groups)"
        )
    n_dev = sites_size(mesh)
    per_dev = n_sites_pad // n_dev
    idx = sorted(np.where([d.process_index == jax.process_index()
                           for d in mesh.devices.flat])[0])
    if not idx:
        return 0, 0
    if idx[-1] - idx[0] + 1 != len(idx):
        raise ValueError(
            "mesh devices of this process are not contiguous along the "
            f"'{AXIS}' axis (positions {idx}); per-host shard reading "
            "requires process-contiguous device order — construct the "
            "mesh from jax.devices() in default order"
        )
    return idx[0] * per_dev, (idx[-1] + 1) * per_dev


def load_global_probs(pars: Params, mesh: Mesh, granule: int = 1):
    """Read this host's site shard and assemble the global sharded
    [S_pad, n_ind, 3] normal-space probability array.

    granule: per-device shard length multiple (site tiles / block size).
    Returns (global_array, s_pad).
    """
    from .mesh import sites_size

    n_dev = sites_size(mesh)
    s_loc = _round_up(_round_up(pars.n_sites, n_dev) // n_dev, granule)
    s_pad = s_loc * n_dev

    start, stop = host_site_range(s_pad, mesh)
    read_stop = min(stop, pars.n_sites)
    read_start = min(start, pars.n_sites)
    if read_stop > read_start:
        geno_log = readers.read_geno(
            pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale,
            pars.n_ind, pars.n_sites, site_range=(read_start, read_stop),
        )
        local = preprocess(geno_log, pars.call_geno, pars.N_thresh, pars.call_thresh)
    else:
        local = np.zeros((0, pars.n_ind, 3))
    pad = (stop - start) - local.shape[0]
    if pad > 0:  # zero padding: inert sites (see parallel/mesh.py)
        local = np.concatenate(
            [local, np.zeros((pad,) + local.shape[1:], local.dtype)], axis=0
        )

    sharding = NamedSharding(mesh, P(AXIS, None, None))
    arr = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local), (s_pad, pars.n_ind, 3)
    )
    return arr, s_pad


class SiteStream:
    """Host-resident per-process site shard with chunked device rounds.

    The reference's only capacity bound is host RAM — it materializes
    the whole [n_ind][n_sites][3] tensor (read_data.cpp:21).  The mesh
    engine's resident path additionally bounds genome length by
    per-device HBM.  This class restores the reference's bound: each
    process keeps its contiguous site range in HOST memory (read once),
    and when the per-device shard exceeds NGSDIST_DEVICE_BUDGET the
    engine iterates fixed-shape ROUNDS — round r places local sites
    [r*chunk, (r+1)*chunk) of every device's shard as one global sharded
    array, so a round's sufficient statistics psum exactly like the
    resident array's, and the site reduction sums over rounds.

    Per-round global site order is a permutation of the padded global
    order (device-major), which is why per-site vectors must be sliced
    with `round_cols` rather than linearly.
    """

    def __init__(self, pars: Params, mesh: Mesh, np_dtype,
                 local_rows: Optional[np.ndarray], s_pad: int, chunk: int,
                 start: int, stop: int,
                 spill_path: Optional[str] = None, spill_norm: bool = False,
                 spill_base: int = 0, spill_owned: bool = False,
                 lut: Optional[np.ndarray] = None, pad_code: int = 0):
        import weakref

        from .mesh import sites_size

        self.pars = pars
        self.mesh = mesh
        self.N = pars.n_ind
        self.S = pars.n_sites
        self.np_dtype = np_dtype
        self.s_pad = s_pad
        self.n_dev = sites_size(mesh)
        self.s_loc = s_pad // self.n_dev
        self.start, self.stop = start, stop
        self.n_local_dev = (stop - start) // self.s_loc
        # Host slab [(stop-start), N, K], padded rows zero.  K = 2 on
        # f32 paths (hostmem.upload23_enabled): the third genotype
        # component is reconstructed ON DEVICE after upload
        # (mesh.expand23_sharded) — 1.5x fewer bytes over the host link
        # and 1/3 less resident host RAM per shard.
        self.local = local_rows
        # Coded shards (hostmem.derive_codes): the host slab is ONE
        # uint8 code per (site, individual) — [(stop-start), N] — and
        # rounds/global uploads expand through the lut on device
        # (distance.expand_codes): 8x fewer link bytes and 24x less
        # shard RAM than the f64 tensor.  Pad rows carry pad_code (the
        # lut's all-zero row), inert exactly like the PAD23 sentinel.
        self.coded = lut is not None
        self.lut = lut
        self.pad_code = pad_code
        if self.coded:
            self.K = 1
        elif local_rows is not None:
            self.K = int(local_rows.shape[-1])
        else:
            self.K = 2 if upload23_enabled(np_dtype) else 3
        # K=2 slab element type: f32 (pack23) or uint16 fixed point
        # (pack16, NGSDIST_UPLOAD16) — round staging buffers and pad
        # sentinels must match, or a dtype-mismatched assignment would
        # value-convert quantized codes.
        if not self.coded and self.K == 2:
            self.slab_dtype = (local_rows.dtype if local_rows is not None
                               else (np.uint16
                                     if upload16_enabled(np_dtype)
                                     else np_dtype))
        else:
            self.slab_dtype = np_dtype
        self.slab_pad = PAD16 if self.slab_dtype == np.uint16 else PAD23
        self.lazy = local_rows is None  # rounds read from disk on demand
        self.chunk = int(min(chunk, self.s_loc))
        # lazy shards always iterate rounds (there is no host tensor to
        # assemble a resident global array from)
        self.resident = (not self.lazy) and self.chunk >= self.s_loc
        # Spill cache for non-seekable inputs (gz/text/stdin): rounds
        # read from the cache instead of the original file.  norm=True
        # caches hold already-log-normalized parsed rows (text spill);
        # norm=False caches are a verbatim decompressed copy of a
        # binary input (rounds re-normalize exactly like direct
        # seekable-binary lazy reads).  base: first site in the cache.
        self.spill_path = spill_path
        self.spill_norm = spill_norm
        self.spill_base = spill_base
        self._spill_fin = None
        if spill_path is not None and spill_owned:
            self._spill_fin = weakref.finalize(
                self, SiteStream._rm_spill, spill_path)

    @staticmethod
    def _rm_spill(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def close(self) -> None:
        """Delete an owned spill cache (idempotent; also runs at GC)."""
        if self._spill_fin is not None:
            self._spill_fin()
            self._spill_fin = None

    # -------------------------- planning ----------------------------- #

    @staticmethod
    def _plan(pars: Params, mesh: Mesh, np_dtype) -> Tuple[int, int]:
        """(s_loc, chunk): per-device shard length and per-round chunk.

        Alignment granule is the bootstrap block size (resum partials
        need block-aligned shards); when the device budget allows a
        RESIDENT shard, the length prefers an lcm(block, 256) multiple
        so the EM tile divisor search finds a healthy tile.  Streaming
        chunks keep the small alignment granule so a tiny budget can
        actually force rounds (the 256 floor must not defeat it) but
        round down to pref multiples when there is room.
        """
        from ..core import distance as _dist
        from .mesh import sites_size

        n_dev = sites_size(mesh)
        g = pars.boot_block_size if pars.n_boot_rep else 1
        pref = int(np.lcm(g, 256)) if not pars.indep_geno else g
        itemsize = np.dtype(np_dtype).itemsize
        budget_sites = _dist._device_budget_bytes() // max(1, pars.n_ind * 3 * itemsize)
        s_min = _round_up(pars.n_sites, n_dev) // n_dev
        s_loc_pref = _round_up(s_min, pref)
        if budget_sites >= s_loc_pref:
            return s_loc_pref, s_loc_pref           # resident, healthy tiles
        s_loc = _round_up(s_min, g)
        if budget_sites >= s_loc:
            return s_loc, s_loc                     # resident, minimal padding
        # streamed rounds double-buffer: reserve the prefetch fraction
        budget_sites = max(
            1, budget_sites * _dist.PREFETCH_KEEP_NUM // _dist.PREFETCH_KEEP_DEN)
        chunk = (budget_sites // pref) * pref or (budget_sites // g) * g or g
        # Pipeline depth: the first round's read has nothing to overlap
        # with, so a barely-over-budget shard split into 2 rounds
        # exposes half its read serially — target STREAM_MIN_CHUNKS
        # rounds (distance._stream_chunk_sites rationale), alignment
        # kept, budget still the hard upper bound.
        depth = _round_up(
            max(-(-s_loc // _dist.STREAM_MIN_CHUNKS),
                _dist.STREAM_MIN_CHUNK_SITES), pref)
        return s_loc, min(chunk, depth)

    # -------------------------- constructors ------------------------- #

    @classmethod
    def from_array(cls, P_host: np.ndarray, pars: Params, mesh: Mesh,
                   np_dtype) -> "SiteStream":
        """Full tensor already in host RAM (single-host runner path)."""
        from .mesh import sites_size

        s_loc, chunk = cls._plan(pars, mesh, np_dtype)
        s_pad = s_loc * sites_size(mesh)
        start, stop = host_site_range(s_pad, mesh)
        hi = max(min(stop, pars.n_sites), start)
        if isinstance(P_host, CodedProbs):
            if coded_upload_enabled(np_dtype):
                lut, pad_code = coded_pad_lut(P_host.lut)
                local = np.full((stop - start, pars.n_ind), pad_code,
                                np.uint8)
                local[: hi - start] = P_host.codes[start:hi]
                return cls(pars, mesh, np_dtype, local, s_pad, chunk,
                           start, stop, lut=lut, pad_code=pad_code)
            P_host = P_host.P
        # Threaded cast+pad: parallel first-touch of the local shard
        # (serial f64->f32 copies run at page-fault speed on VMs).
        # pack23 marks pad rows AND data-borne all-zero triples with
        # the PAD23 sentinel so the device expansion restores them.
        if upload23_enabled(np_dtype):
            local = pack23(P_host[start:hi], np_dtype, stop - start,
                           may_zero=not pars.in_bin)
        else:
            local = parallel_cast_pad(P_host[start:hi], np_dtype,
                                      stop - start)
        return cls(pars, mesh, np_dtype, local, s_pad, chunk, start, stop)

    @staticmethod
    def _host_budget_bytes() -> int:
        """Host-RAM budget for a process's resident site shard.  Above
        it (binary, seekable inputs) the stream goes LAZY: no host
        tensor at all — each round reads its own site rows from disk,
        so neither device HBM nor host RAM bounds genome length (the
        reference's only capacity bound is host RAM, read_data.cpp:21).
        Default: half of MemAvailable; NGSDIST_HOST_BUDGET overrides
        (bytes)."""
        env = os.environ.get("NGSDIST_HOST_BUDGET")
        if env:
            return max(1, int(env))
        try:
            with open("/proc/meminfo") as fh:
                for ln in fh:
                    if ln.startswith("MemAvailable:"):
                        return max(1 << 30, int(ln.split()[1]) * 1024 // 2)
        except OSError:
            pass
        return 1 << 62

    @staticmethod
    def seekable_binary(pars: Params) -> bool:
        """True when per-round disk reads are possible: binary input,
        not stdin, not gzip-compressed (site_range seeks directly)."""
        return bool(pars.in_geno and pars.in_bin and pars.in_geno != "-"
                    and not pars.in_geno.endswith(".gz"))

    @classmethod
    def coded_call_eligible(cls, pars: Params, np_dtype) -> bool:
        """The SHARED gate for every fused-codes route (the eager plane,
        the deferred CodedBinInput handle, lazy coded rounds): raw
        DEFAULT-THRESHOLD --call_geno semantics fully determine each
        triple from a uint8 code.  One predicate so the runner and
        from_reader can never disagree (same rule as wants_lazy).
        Requires the native reader (read_geno_codes returns None
        without it), models 0-2 (the coded-upload contract), no
        per-site debug replay, and coded uploads on for the engine
        dtype; NGSDIST_FUSED_READ=0 forces the staged chain."""
        from ..utils import native as _native

        if os.environ.get("NGSDIST_FUSED_READ", "auto") == "0":
            return False
        if (not pars.call_geno or pars.N_thresh != 0.0
                or pars.call_thresh != 0.0):
            return False
        if pars.evol_model >= 3 or pars.verbose >= 8:
            return False
        return coded_upload_enabled(np_dtype) and _native.have_native()

    @classmethod
    def wants_coded_lazy(cls, pars: Params, np_dtype) -> bool:
        """True when LAZY rounds can derive uint8 call_geno codes per
        round: each round then ships 1 byte/triple over the host link
        instead of the packed slab (8x fewer link bytes; binary sources
        also skip the read -> preprocess -> pack staging entirely — and
        bootstrap replicates re-read rounds under lazy, multiplying the
        win).  Three round sources: raw seekable binary and the
        decompressed binary spill go through the fused native reader
        (readers.read_geno_codes); the TEXT spill's already-normalized
        log rows classify in-place (first-argmax / all-equal — the
        exact nd_call_geno3 decision on the exact stored values, no
        re-normalize).  Direct seekable reads also require the
        raw-magic sniff (a gz-magic file behind a non-.gz name reads
        through read_geno's gz path, which the fused reader refuses)."""
        if not cls.coded_call_eligible(pars, np_dtype):
            return False
        if cls.seekable_binary(pars):
            return readers.is_raw_seekable_binary(pars.in_geno)
        return True

    @classmethod
    def wants_lazy(cls, pars: Params, np_dtype, n_rows: int) -> bool:
        """True when eagerly loading n_rows sites (the f64 read tensor
        plus the cast shard) would exceed the host budget.  EVERY input
        style supports lazy per-round reads — seekable binary directly,
        everything else (gz/plain text, gzipped binary, stdin) via a
        one-pass spill cache (_build_spill) — so neither host RAM nor
        HBM bounds genome length on ANY input (the reference's only
        bound is host RAM for all of them, read_data.cpp:21).  The
        runner and from_reader share this single predicate."""
        itemsize = np.dtype(np_dtype).itemsize
        need = n_rows * pars.n_ind * 3 * (itemsize + 8)
        return need > cls._host_budget_bytes()

    @classmethod
    def from_reader(cls, pars: Params, mesh: Mesh,
                    np_dtype) -> "SiteStream":
        """Each process reads only its own site range of the genotype
        file (io/readers.py site_range) — the multi-host path.  Shards
        beyond the host budget stream rounds from disk (lazy)."""
        from ..core import distance as _dist
        from .mesh import sites_size

        s_loc, chunk = cls._plan(pars, mesh, np_dtype)
        s_pad = s_loc * sites_size(mesh)
        start, stop = host_site_range(s_pad, mesh)
        itemsize = np.dtype(np_dtype).itemsize
        if cls.wants_lazy(pars, np_dtype, stop - start):
            # Lazy rounds are bounded by BOTH budgets: the host staging
            # (round buffer + f64 read slab + prefetched round ~ 3x) and
            # the device working set with its prefetch reservation —
            # _plan's resident early-return skips the latter, so it is
            # re-applied here.
            n_local_dev = (stop - start) // s_loc
            g = pars.boot_block_size if pars.n_boot_rep else 1
            pref = g if pars.indep_geno else int(np.lcm(g, 256))
            host_sites = (cls._host_budget_bytes() // 3) // max(
                1, n_local_dev * pars.n_ind * 3 * itemsize)
            dev_sites = (_dist._device_budget_bytes()
                         * _dist.PREFETCH_KEEP_NUM
                         // _dist.PREFETCH_KEEP_DEN) // max(
                             1, pars.n_ind * 3 * itemsize)
            sites = min(host_sites, dev_sites)
            sites = (sites // pref) * pref or (sites // g) * g or g
            chunk = min(chunk, sites)
            spill = {}
            if not cls.seekable_binary(pars):
                spill = cls._build_spill(pars, start, stop)
            coded = {}
            if cls.wants_coded_lazy(pars, np_dtype):
                # the lut must be chosen before any round is read —
                # _call_lut_padded is static, so every process agrees
                # without a broadcast.  Binary sources never emit the
                # NaN row (the native reader fatals on NaN like the
                # reference); text rounds classify literal-nan to it.
                lut, pad_code = _call_lut_padded()
                coded = dict(lut=lut, pad_code=pad_code)
            return cls(pars, mesh, np_dtype, None, s_pad, chunk, start, stop,
                       **spill, **coded)
        read_start = min(start, pars.n_sites)
        read_stop = min(stop, pars.n_sites)
        if cls.wants_coded_lazy(pars, np_dtype):
            # RESIDENT coded shard (the multi-host analogue of the
            # runner's eager code plane): raw seekable binary reads
            # codes in one fused native pass; every other source reads
            # its log-normalized rows and classifies in place.  24x
            # less shard RAM and 8x fewer upload bytes than the staged
            # slab, bit-identical expansion.
            lut, pad_code = _call_lut_padded()
            local = np.full((stop - start, pars.n_ind), pad_code, np.uint8)
            if read_stop > read_start:
                got = None
                if cls.seekable_binary(pars):  # raw-magic sniffed in gate
                    got = readers.read_geno_codes(
                        pars.in_geno, pars.in_logscale, pars.n_ind,
                        pars.n_sites, site_range=(read_start, read_stop))
                codes = got[0] if got is not None else _classify_call_rows(
                    readers.read_geno(
                        pars.in_geno, pars.in_bin, pars.in_probs,
                        pars.in_logscale, pars.n_ind, pars.n_sites,
                        site_range=(read_start, read_stop)))
                local[: read_stop - read_start] = codes
            return cls(pars, mesh, np_dtype, local, s_pad, chunk, start,
                       stop, lut=lut, pad_code=pad_code)
        if read_stop > read_start:
            geno_log = readers.read_geno(
                pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale,
                pars.n_ind, pars.n_sites, site_range=(read_start, read_stop),
            )
            pre = preprocess(
                geno_log, pars.call_geno, pars.N_thresh, pars.call_thresh
            )
        else:
            pre = np.zeros((0, pars.n_ind, 3), np_dtype)
        if upload23_enabled(np_dtype):
            local = pack23(pre, np_dtype, stop - start,
                           may_zero=not pars.in_bin)
        else:
            local = parallel_cast_pad(pre, np_dtype, stop - start)
        return cls(pars, mesh, np_dtype, local, s_pad, chunk, start, stop)

    # ------------------------- spill cache --------------------------- #

    @classmethod
    def _build_spill(cls, pars: Params, start: int, stop: int) -> dict:
        """One-pass spill of a non-seekable input (gz/text/stdin) into
        a per-process disk cache so lazy rounds can seek it.  TEXT
        inputs parse once through the native slab-parallel reader
        (readers.spill_text_geno) into already-normalized rows;
        GZIPPED/STDIN BINARY inputs are copied verbatim (decompressed)
        and rounds normalize per read exactly like direct seekable-
        binary lazy runs.  Cache location: NGSDIST_SPILL_DIR (default
        system temp — point it at a big disk for genomes beyond it)."""
        import tempfile

        base = os.environ.get("NGSDIST_SPILL_DIR") or None
        fd, cache = tempfile.mkstemp(prefix="ngsdist_spill_", suffix=".bin",
                                     dir=base)
        os.close(fd)
        lo = min(start, pars.n_sites)
        hi = min(stop, pars.n_sites)
        try:
            if pars.in_bin:
                cls._copy_binary(pars, cache, lo, hi)
                return dict(spill_path=cache, spill_norm=False,
                            spill_base=lo, spill_owned=True)
            readers.spill_text_geno(
                pars.in_geno, pars.in_probs, pars.in_logscale, pars.n_ind,
                pars.n_sites, cache, site_range=(lo, hi),
            )
            return dict(spill_path=cache, spill_norm=True, spill_base=lo,
                        spill_owned=True)
        except BaseException:
            cls._rm_spill(cache)
            raise

    @staticmethod
    def _copy_binary(pars: Params, cache: str, start: int, stop: int) -> None:
        """Decompress-copy rows [start, stop) of a gz/stdin binary GP
        stream to `cache` — each process spills only its own site shard
        (total disk across P processes is ONE genome, not P), skipping
        bytes before its shard and discard-reading after it so the
        reference's read-time size fatals still fire (premature EOF /
        not at EOF, read_data.cpp:29-47,106-109).  NaN checks stay at
        round-read time, like direct seekable-binary lazy runs.  Only
        non-seekable sources reach here (gz/stdin — the _build_spill
        call-site guard); plain binary files are read lazily in place,
        never spilled."""
        import gzip
        import sys as _sys

        from ..config import NgsDistError

        want = pars.n_sites * pars.n_ind * 3 * 8
        row = pars.n_ind * 3 * 8
        keep_lo, keep_hi = start * row, stop * row
        src = (_sys.stdin.buffer if pars.in_geno == "-" else
               gzip.open(pars.in_geno, "rb"))
        total = 0
        try:
            with open(cache, "wb") as out:
                while True:
                    buf = src.read(16 << 20)
                    if not buf:
                        break
                    new = total + len(buf)
                    if new > want:
                        raise NgsDistError(
                            "read_geno",
                            "GENO file not at EOF. Check GENO file and "
                            "number of sites!",
                        )
                    a, b = max(total, keep_lo), min(new, keep_hi)
                    if b > a:
                        out.write(buf[a - total: b - total])
                    total = new
        finally:
            if src is not _sys.stdin.buffer:
                src.close()
        if total < want:
            raise NgsDistError(
                "read_geno",
                "GENO file at premature EOF. Check GENO file and number "
                "of sites!",
            )

    def _read_rows(self, g_lo: int, g_hi: int) -> np.ndarray:
        """Log-space rows [g_lo, g_hi) for a lazy round: from the
        original seekable binary, the verbatim binary cache (both
        normalize per read), or the text spill cache (already
        normalized — re-normalizing would break byte parity)."""
        p = self.pars
        if self.spill_path is None:
            return readers.read_geno(
                p.in_geno, p.in_bin, p.in_probs, p.in_logscale,
                p.n_ind, p.n_sites, site_range=(g_lo, g_hi),
            )
        if self.spill_norm:
            return readers.read_spill_rows(
                self.spill_path, p.n_ind, g_lo, g_hi, base=self.spill_base)
        # verbatim binary cache holds ONLY this process's shard rows
        # [spill_base, min(stop, n_sites)) — rebase the read window
        rows = min(self.stop, p.n_sites) - self.spill_base
        return readers.read_geno(
            self.spill_path, True, p.in_probs, p.in_logscale,
            p.n_ind, rows,
            site_range=(g_lo - self.spill_base, g_hi - self.spill_base),
        )

    def _read_codes(self, g_lo: int, g_hi: int) -> np.ndarray:
        """uint8 call_geno codes for rows [g_lo, g_hi) of a lazy CODED
        round: one fused native pass over the raw f64 binary source or
        the decompressed binary spill; the TEXT spill's stored
        log-normalized rows classify directly (the default-threshold
        nd_call_geno3 decision — one-hot at the FIRST argmax, exactly
        all-equal rows missing — applied to the exact values the
        staged round would call, so the expansion through
        coded_call_lut is bit-identical to preprocess+exp)."""
        p = self.pars
        if self.spill_norm:  # text spill: log rows, already normalized
            return _classify_call_rows(readers.read_spill_rows(
                self.spill_path, p.n_ind, g_lo, g_hi, base=self.spill_base))
        if self.spill_path is None:
            got = readers.read_geno_codes(
                p.in_geno, p.in_logscale, p.n_ind, p.n_sites,
                site_range=(g_lo, g_hi))
        else:
            rows = min(self.stop, p.n_sites) - self.spill_base
            got = readers.read_geno_codes(
                self.spill_path, p.in_logscale, p.n_ind, rows,
                site_range=(g_lo - self.spill_base,
                            g_hi - self.spill_base))
        if got is None:  # not raw binary after all (TOCTOU): hard error
            from ..config import NgsDistError

            raise NgsDistError("read_geno", "cannot read binary GENO "
                               "file. Check GENO file and number of sites!")
        return got[0]

    # ------------------------- resident path ------------------------- #

    def _put(self, local: np.ndarray, spec, global_shape):
        """Assemble a global sharded array from this process's rows.
        Single-process: plain device_put (handles replication over a
        'pairs' axis); multi-process: per-process shard assembly."""
        sharding = NamedSharding(self.mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(local, sharding)
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(local), global_shape
        )

    def _put_probs(self, local, n_rows: int):
        """Upload a [rows, N, K] probability slab (or a [rows, N] uint8
        code plane) and return the sharded [rows, N, 3] tensor (K=2
        slabs and code planes expand on device)."""
        if self.coded:
            import jax.numpy as jnp

            from ..core.distance import expand_codes

            arr = self._put(local, P(AXIS, None), (n_rows, self.N))
            return expand_codes(
                arr, jnp.asarray(self.lut.astype(self.np_dtype)))
        arr = self._put(local, P(AXIS, None, None), (n_rows, self.N, self.K))
        if self.K == 2:
            from .mesh import expand23_sharded

            return expand23_sharded(arr)
        return arr

    def global_array(self):
        """The whole padded [s_pad, N, 3] array sharded over the mesh."""
        return self._put_probs(self.local, self.s_pad)

    # ------------------------- streaming path ------------------------ #

    @property
    def n_rounds(self) -> int:
        return (self.s_loc + self.chunk - 1) // self.chunk

    @property
    def round_sites(self) -> int:
        """Global sites per round (fixed shape; tail rounds zero-pad)."""
        return self.chunk * self.n_dev

    def round_data(self, r: int):
        """Global sharded [chunk*n_dev, N, 3] array for round r."""
        lo = r * self.chunk
        hi = min(lo + self.chunk, self.s_loc)
        if self.coded:
            out = np.full((self.n_local_dev, self.chunk, self.N),
                          self.pad_code, np.uint8)
            if self.lazy:
                # coded rounds read uint8 codes straight from disk
                # (one fused native pass, _read_codes); pad rows keep
                # pad_code — inert exactly like the staged PAD23 rows
                d0 = self.start // self.s_loc
                for d in range(self.n_local_dev):
                    g_lo = min((d0 + d) * self.s_loc + lo, self.S)
                    g_hi = min((d0 + d) * self.s_loc + hi, self.S)
                    if g_hi > g_lo:
                        out[d, : g_hi - g_lo] = self._read_codes(g_lo, g_hi)
            else:
                l3 = self.local.reshape(
                    self.n_local_dev, self.s_loc, self.N)
                out[:, : hi - lo] = l3[:, lo:hi]
            return self._put_probs(out.reshape(-1, self.N),
                                   self.round_sites)
        out = np.zeros((self.n_local_dev, self.chunk, self.N, self.K),
                       self.slab_dtype if self.K == 2 else self.np_dtype)
        # 2-component rounds: rows without real data (round tails) get
        # the PAD23 sentinel so the on-device expansion restores the
        # all-zero padded triples the unweighted reductions (streamed
        # block partials) rely on; lazy reads route through pack23,
        # which also marks data-borne all-zero triples (empty-line
        # missing sites).
        if self.lazy:
            # Read this round's rows of every local device's shard from
            # disk (binary seek via site_range), preprocess, cast.  The
            # engines' one-round lookahead overlaps this IO with the
            # in-flight round's device compute.
            d0 = self.start // self.s_loc
            for d in range(self.n_local_dev):
                g_lo = min((d0 + d) * self.s_loc + lo, self.S)
                g_hi = min((d0 + d) * self.s_loc + hi, self.S)
                if g_hi > g_lo:
                    geno_log = self._read_rows(g_lo, g_hi)
                    pre = preprocess(
                        geno_log, self.pars.call_geno, self.pars.N_thresh,
                        self.pars.call_thresh,
                    )
                    if self.K == 2:
                        # zeros can only come from text-parsed rows
                        # (the spill_norm cache); binary reads cannot
                        out[d] = pack23(pre, self.np_dtype, self.chunk,
                                        may_zero=self.spill_norm)
                    else:
                        out[d, : g_hi - g_lo] = pre
                elif self.K == 2:
                    out[d, :, :, 0] = self.slab_pad
        else:
            l3 = self.local.reshape(
                self.n_local_dev, self.s_loc, self.N, self.K)
            out[:, : hi - lo] = l3[:, lo:hi]
            if self.K == 2 and hi - lo < self.chunk:
                out[:, hi - lo:, :, 0] = self.slab_pad
        return self._put_probs(out.reshape(-1, self.N, self.K),
                               self.round_sites)

    def round_cols(self, r: int, M_full: np.ndarray):
        """Global sharded per-site vector/matrix for round r.

        M_full: [S] or [S, K] defined on the TRUE site range; padding
        and tail rounds are zero-filled (inert under the engines'
        weight semantics)."""
        M_full = np.asarray(M_full)
        K = None if M_full.ndim == 1 else M_full.shape[1]
        lo = r * self.chunk
        hi = min(lo + self.chunk, self.s_loc)
        shape = (self.n_local_dev, self.chunk) + ((K,) if K else ())
        out = np.zeros(shape, self.np_dtype)
        # local device d covers global sites [(d0+d)*s_loc, ...) where
        # d0 = start // s_loc
        d0 = self.start // self.s_loc
        for d in range(self.n_local_dev):
            g_lo = (d0 + d) * self.s_loc + lo
            g_hi = min((d0 + d) * self.s_loc + hi, self.S)
            if g_hi > g_lo:
                out[d, : g_hi - g_lo] = M_full[g_lo:g_hi]
        spec = P(AXIS) if K is None else P(AXIS, None)
        gshape = (self.round_sites,) + ((K,) if K else ())
        return self._put(out.reshape((-1,) + ((K,) if K else ())), spec, gshape)


def plan_granule(pars: Params) -> int:
    """Per-device shard-length multiple for load_global_probs so that
    every sharded_suffstats variant a run needs is satisfiable: block
    alignment for bootstrap partials, plus a composite factor so the EM
    tile divisor search finds a healthy tile."""
    g = pars.boot_block_size if pars.n_boot_rep else 1
    if not pars.indep_geno:
        g = int(np.lcm(g, 256))
    return g


def run_distributed(pars: Params, coordinator: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    resume: bool = False,
                    local_device_ids: Optional[Sequence[int]] = None):
    """Full multi-host pipeline (BASELINE.json scale-out config): every
    process reads its own site shard, the mesh engine psum-merges
    sufficient statistics over all devices of all processes, and process
    0 streams the phylip matrices to pars.out.

    Single-process invocations run the same code over the local devices.
    Returns the matrices on process 0, [] elsewhere.

    resume: process 0 reads the .ckpt.json sidecar and the already-done
    replicate count is broadcast to every process, which then SKIPS
    computing those replicates entirely (the bootstrap index table is a
    pure function of the seed).  Signals are armed: a graceful stop
    finishes the in-flight replicate on every process (each process
    observes its own signal — in managed deployments the signal is
    delivered to the whole job) and leaves a resumable sidecar.
    """
    import jax

    from ..core import bootstrap as bt
    from ..core import models
    from ..core.distance import _iter_replicates_extended, _iter_replicates_sharded
    from ..io import readers, writers
    from ..utils import checkpoint as ckpt
    from ..utils import signals
    from .mesh import make_mesh

    bring_up(coordinator, num_processes, process_id, local_device_ids)
    signals.arm()
    pars.validate()
    from ..utils import compile_cache

    compile_cache.enable()
    try:
        pars.finalize()
    except Exception:
        # banners accumulated before a finalize-time fatal still print
        # (reference order: stage banners stream as it goes)
        if jax.process_index() == 0:
            import sys

            for msg in pars.messages:
                print(msg, file=sys.stderr)
        raise
    # Models 3-6 run the sharded extended path (the reference aborts on
    # them, ngsDist.cpp:387-398; the jax engine implements them) — every
    # process reads the small POS file whole for the allele codes.
    alleles = None
    if pars.evol_model >= 3:
        from ..core.submodels import encode_alleles

        if not pars.in_pos:
            from ..config import NgsDistError

            raise NgsDistError(
                "main", "evolutionary models need allele info in the POS file!"
            )
        pos_rows = readers.read_pos(pars.in_pos, pars.in_pos_header, pars.n_sites)
        alleles = encode_alleles(pos_rows)
    else:
        models.check_model_supported(pars.evol_model)
    if jax.process_index() == 0:
        import sys

        for msg in pars.messages:
            print(msg, file=sys.stderr)

    mesh = make_mesh()
    # Each process reads its site range ONCE into host RAM; the stream
    # either places it resident (one padded global array) or iterates
    # fixed-shape site rounds when the per-device shard exceeds
    # NGSDIST_DEVICE_BUDGET (long-genome scaling, SURVEY.md §5).
    np_dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    stream = SiteStream.from_reader(pars, mesh, np_dtype)

    n_trunc, maps = bt.site_maps(
        pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size
    )

    is_writer = jax.process_index() == 0

    # Resume: the writer decides how many matrices are already durable;
    # every process must agree so the skipped replicates never enter the
    # collective stream.
    n_done = 0
    if resume:
        if is_writer:
            got = ckpt.load(pars.out, pars, engine="jax")
            n_done = got or 0
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            n_done = int(multihost_utils.broadcast_one_to_all(
                np.asarray(n_done, np.int32)))
        if is_writer and n_done:
            import sys

            print(f"==> Resuming: {n_done} matrices already written",
                  file=sys.stderr)

    labels = None
    out_fh = None
    if is_writer:
        labels = (
            readers.read_labels(pars.in_labels, pars.in_labels_header, pars.n_ind)
            if pars.in_labels else readers.default_labels(pars.n_ind)
        )
        out_fh = open(pars.out, "a" if n_done else "w")
    if pars.evol_model >= 3:
        rep_stream = _iter_replicates_extended(
            pars, stream, maps, n_trunc, alleles, mesh=mesh, start_rep=n_done,
            round_ckpt=True,
        )
    else:
        rep_stream = _iter_replicates_sharded(pars, stream, maps, n_trunc, mesh,
                                              start_rep=n_done,
                                              round_ckpt=True)
    matrices = []
    interrupted = False
    try:
        for rep, m in enumerate(rep_stream, start=n_done):
            if is_writer:
                writers.write_dist_matrix(out_fh, labels, m)
                out_fh.flush()
                matrices.append(m)
                ckpt.save(pars.out, pars, rep + 1, engine="jax")
            if signals.stop_requested():
                interrupted = True
                if is_writer:
                    import sys

                    print("==> Stop requested; output is resumable (--resume)",
                          file=sys.stderr)
                break
    finally:
        if out_fh is not None:
            out_fh.close()
        stream.close()  # delete an owned spill cache (gz/text lazy runs)
    if is_writer and not interrupted:
        ckpt.clear(pars.out)
    return matrices
