#!/usr/bin/env python
"""Headline benchmarks: pair-site distance updates/sec on one chip.

The DEFAULT invocation (what the driver runs) measures ALL headline
metrics, each against its reference-CPU anchor in BENCH_baseline.json
(produced by tests/refharness/measure_cpu_baseline.py):

  indep  full-matrix sufficient statistics at the BASELINE.json shape
         (1k individuals x 1M sites, independent-genotypes path with
         pairwise deletion) streamed through the engine's contraction
         (core/distance.indep_suffstats) [reference hot loop /root/reference/ngsDist.cpp:325-404,
         9 fused multiply-adds per pair-site update]
  em     EM-path sufficient statistics (per-(pair,site) 9-cell EM to
         convergence, through the engine's dispatch: the EM kernel on a
         GPU in f32) incl. a bootstrap-weighted replicate on the SAME
         compiled shape [reference emOptim2.cpp:77-135]
  e2e    the real CLI pipeline: binary-GP file -> native reader ->
         preprocess -> device kernels -> phylip writer (runner.run),
         user-visible wall-time updates/sec

and prints ONE combined JSON line whose top-level metric is the indep
headline, with the other modes under "metrics":

  {"metric": "pair_site_updates_per_sec", "value": N, "unit":
   "updates/s", "vs_baseline": N, "metrics": {"em": {...}, "e2e":
   {...}}}

A mode that fails records {"error": ...} under "metrics" and does not
sink the run; the headline falls back to the first mode that succeeded.

Single-mode runs (bench.py --indep | --em | --e2e) print that mode's
JSON line alone, as before.

Env knobs: NGSDIST_BENCH_N_IND, NGSDIST_BENCH_N_SITES,
NGSDIST_BENCH_CHUNK override the shape (e.g. for a quick smoke run).
NGSDIST_BENCH_PLATFORM pins the jax backend post-import (e.g. "cpu",
the same mechanism as the CLI's --platform flag).  NGSDIST_BENCH_BUDGET
(seconds, default 1100) bounds the default invocation's total wall
time: a mode whose estimated cost exceeds the remaining budget is
skipped up front rather than started.  NGSDIST_BENCH_CACHE points at
the generated-input cache directory (default
/dev/shm/ngsdist_bench_cache): inputs are keyed by (N, S, seed) and
reused across modes AND invocations.  The combined JSON line is ALSO
emitted after every mode (last line wins), so a run cut by a timeout
still leaves a parseable record.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_FILE = os.path.join(REPO, "BENCH_baseline.json")


def _baseline(key: str) -> float:
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as fh:
            return float(json.load(fh).get(key, 0.0))
    return 0.0


def _record(metric: str, value: float, unit: str, baseline_key: str) -> dict:
    ref = _baseline(baseline_key)
    return {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": value / ref if ref > 0 else 0.0,
    }


def main_em() -> dict:
    """EM-path kernel throughput, incl. a weighted bootstrap replicate
    reusing the same compiled shape."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from ngsdist_jax.config import default_score_matrix
    from ngsdist_jax.core.distance import em_pair_stats

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_N_SITES", 4096))
    dev = jax.devices()[0]
    rng_key = jax.random.PRNGKey(0)
    P = jax.nn.softmax(jax.random.normal(rng_key, (S, N, 3), jnp.float32), axis=-1)
    P = jax.device_put(P, dev)
    score9 = jnp.asarray(default_score_matrix().reshape(-1), jnp.float32)
    w = jnp.asarray(
        (jax.random.randint(jax.random.PRNGKey(1), (S,), 0, 3)).astype(jnp.float32)
    )

    def full(weights):
        raw, cnt = em_pair_stats(P, score9, True, site_weights=weights)
        # scalar barrier: no matrix fetch inside the timed region
        return jnp.sum(raw)

    _ = np.asarray(full(None))  # compile rep-0 shape
    _ = np.asarray(full(w))     # compile the weighted (replicate) shape
    times = []
    for _i in range(3):
        t0 = time.perf_counter()
        r0 = full(None)
        r1 = full(w)          # bootstrap replicate: same kernel, new weights
        np.asarray(r0); np.asarray(r1)
        times.append((time.perf_counter() - t0) / 2)
    elapsed = min(times)
    ups = (N * (N - 1) / 2) * S / elapsed
    print(f"# EM kernel {N} ind x {S} sites, full+weighted replicate on "
          f"{dev.platform}:{dev.device_kind}", file=sys.stderr)
    return _record("em_pair_site_updates_per_sec", ups, "updates/s",
                   "cpu64_em_updates_per_sec")


def _cache_dir() -> str:
    """Generated-input cache, /dev/shm by default: inputs persist
    across bench invocations until reboot."""
    d = os.environ.get("NGSDIST_BENCH_CACHE")
    if not d:
        d = ("/dev/shm/ngsdist_bench_cache"
             if os.access("/dev/shm", os.W_OK) else
             os.path.join(tempfile.gettempdir(), "ngsdist_bench_cache"))
    os.makedirs(d, exist_ok=True)
    return d


def _get_gp_bin(N: int, S: int, seed: int = 7) -> tuple[str, float]:
    """Return (path, gen_seconds) for the [S, N, 3] binary GP input at
    this shape, generating into the cache only on a miss.  Generation
    is deterministic in (N, S, seed), so a cached file is byte-exact
    for every mode sharing the shape (e2e and e2e_cg share 1024x64k).
    Written via tmp+rename so a killed run never caches a short file."""
    path = os.path.join(_cache_dir(), f"gp_{N}x{S}_s{seed}.bin")
    want = S * N * 24
    if os.path.exists(path) and os.path.getsize(path) == want:
        return path, 0.0
    tmp = path + ".tmp"
    dt = _gen_gp_bin(tmp, N, S, seed)
    os.replace(tmp, path)
    return path, dt


def _gen_gp_bin(path: str, N: int, S: int, seed: int = 7) -> float:
    """Write an [S, N, 3] Dirichlet(1,1,1) binary GP file.  Large files
    tile one random 64k-site block byte-wise (content does not affect
    indep-path timing; generation would otherwise dominate the mode)."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    block_sites = min(S, 1 << 16)
    chunk = 1 << 14
    parts = []
    for s0 in range(0, block_sites, chunk):
        n = min(chunk, block_sites - s0)
        # Dirichlet(1,1,1) via normalized exponentials — same
        # distribution as rng.dirichlet, ~40x faster
        g = rng.exponential(size=(n, N, 3))
        g /= g.sum(axis=-1, keepdims=True)
        parts.append(g.tobytes())
    block = b"".join(parts)
    full, rem = divmod(S, block_sites)
    # threaded pwrite: serial writes page-fault at ~10 MB/s/thread on
    # this sandbox (first touch of fresh tmpfs pages), so a 26 GB input
    # would cost minutes of the bench budget single-threaded
    import threading

    fd = os.open(path, os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o644)
    try:
        os.truncate(fd, S * N * 24)

        def write_at(i):
            os.pwrite(fd, block, i * len(block))

        kmax = full + (1 if rem else 0)
        idx = iter(range(kmax))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    k = next(idx, None)
                if k is None:
                    return
                if k < full:
                    write_at(k)
                else:
                    os.pwrite(fd, block[: rem * N * 24], full * len(block))

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        os.close(fd)
    return time.perf_counter() - t0


def _e2e_pars(geno, N, S, out, **kw):
    from ngsdist_jax.config import Params

    kw.setdefault("seed", 1)
    kw.setdefault("indep_geno", True)
    pars = Params(in_geno=geno, in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S,
                  pairwise_del=True, evol_model=1, verbose=0,
                  out=out, **kw)
    pars.validate(); pars.finalize()
    return pars


def main_e2e() -> dict:
    """End-to-end CLI pipeline wall-time: binary GP file -> fused
    native reader -> device kernels -> phylip writer (runner.run).

    Default shape 1024 x 64k: large enough that the O(N^2 S) distance
    compute amortizes the O(N S) IO (at 256 ind the pipeline is pure
    reader/upload).  The input lives on tmpfs, so the disk is not
    what is measured.  The pipeline runs 5 times: the cold run pays
    first-ever compiles (amortized in production by the persistent XLA
    compile cache, utils/compile_cache), and the headline is the MIN
    of the 4 post-compile runs with the median and every sample
    recorded.  Override the shape with
    NGSDIST_BENCH_N_IND/N_SITES.
    """
    import shutil

    sys.path.insert(0, REPO)
    from ngsdist_jax import runner

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_N_SITES", 1 << 16))
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    geno, gen_time = _get_gp_bin(N, S)
    td = tempfile.mkdtemp(dir=base)
    try:
        times = []
        for it in range(5):
            pars = _e2e_pars(geno, N, S, os.path.join(td, f"out{it}.dist"))
            t0 = time.perf_counter()
            runner.run(pars, engine="jax")
            times.append(time.perf_counter() - t0)
            if it >= 1 and _deadline_passed():
                break
    finally:
        shutil.rmtree(td, ignore_errors=True)
    cold, post = times[0], sorted(times[1:])
    warm = post[0]
    med = post[(len(post) - 1) // 2]
    ups = (N * (N - 1) / 2) * S / warm
    print(f"# e2e {N} ind x {S} sites: input gen {gen_time:.1f}s, "
          f"pipeline cold {cold:.1f}s / warm min {warm:.1f}s "
          f"median {med:.1f}s (fused reader+kernel+writer)",
          file=sys.stderr)
    rec = _record("e2e_pair_site_updates_per_sec", ups, "updates/s",
                  "cpu64_updates_per_sec")
    rec["cold_s"] = round(cold, 3)
    rec["warm_s"] = round(warm, 3)
    rec["warm_median_s"] = round(med, 3)
    rec["samples_s"] = [round(t, 3) for t in times]
    return rec


def main_e2e_cg() -> dict:
    """Coded-upload end-to-end: --call_geno on binary GP hard-calls
    every non-missing triple (gen_func.cpp:886-914 with default
    thresholds), so the engine ships uint8 codes + a lookup table —
    1 byte per (site, individual) over the host link instead of the
    8-byte packed f32 slab (hostmem.derive_codes, NGSDIST_CODED_UPLOAD).
    Same shape as the headline e2e; 3 runs (cold + 2), min reported."""
    import shutil

    sys.path.insert(0, REPO)
    from ngsdist_jax import runner

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_N_SITES", 1 << 16))
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    geno, gen_time = _get_gp_bin(N, S)
    td = tempfile.mkdtemp(dir=base)
    try:
        times = []
        for it in range(3):
            pars = _e2e_pars(geno, N, S, os.path.join(td, f"out{it}.dist"),
                             call_geno=True)
            t0 = time.perf_counter()
            runner.run(pars, engine="jax")
            times.append(time.perf_counter() - t0)
            if it >= 1 and _deadline_passed():
                break
    finally:
        shutil.rmtree(td, ignore_errors=True)
    warm = min(times[1:]) if len(times) > 1 else times[0]
    ups = (N * (N - 1) / 2) * S / warm
    print(f"# e2e-cg {N} ind x {S} sites (--call_geno, coded uint8 "
          f"uploads): input gen {gen_time:.1f}s, pipeline "
          f"{'/'.join(f'{t:.1f}' for t in times)}s", file=sys.stderr)
    rec = _record("cg_e2e_pair_site_updates_per_sec", ups, "updates/s",
                  "cpu64_updates_per_sec")
    rec["samples_s"] = [round(t, 3) for t in times]
    return rec


def main_e2e_1m() -> dict:
    """The BASELINE.json headline shape end-to-end: 1k individuals x 1M
    sites (25.8 GB binary GP) through the real CLI pipeline.  The f32
    working set (12.9 GB) exceeds NGSDIST_DEVICE_BUDGET/3, so this
    exercises the CHUNKED stream: fused packed reads from disk
    overlapping the async host->device copy per chunk — no resident
    host tensor at any point.  One timed run (a second if the wall
    budget allows; min reported) — the compile cache makes reruns
    equivalent to warm runs at this chunk shape."""
    import shutil

    sys.path.insert(0, REPO)
    from ngsdist_jax import runner

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_1M_SITES", 1 << 20))
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    geno, gen_time = _get_gp_bin(N, S)
    td = tempfile.mkdtemp(dir=base)
    try:
        print(f"# e2e-1M: input ready ({gen_time:.0f}s), starting runs",
              file=sys.stderr, flush=True)
        runs = int(os.environ.get("NGSDIST_BENCH_1M_RUNS", "2"))
        times = []
        for it in range(runs):
            pars = _e2e_pars(geno, N, S, os.path.join(td, f"out{it}.dist"))
            t0 = time.perf_counter()
            runner.run(pars, engine="jax")
            times.append(time.perf_counter() - t0)
            print(f"# e2e-1M: run {it} {times[-1]:.0f}s", file=sys.stderr,
                  flush=True)
            # A repeat run costs ~the first (compile cache makes run 0
            # warm); only take it when it clearly fits what's left.
            if _DEADLINE is not None and \
                    time.perf_counter() + 1.1 * times[-1] > _DEADLINE:
                break
    finally:
        shutil.rmtree(td, ignore_errors=True)
    warm = min(times)
    ups = (N * (N - 1) / 2) * S / warm
    print(f"# e2e-1M {N} ind x {S} sites (chunked fused stream): input "
          f"gen {gen_time:.1f}s, pipeline {'/'.join(f'{t:.1f}' for t in times)}s",
          file=sys.stderr)
    rec = _record("e2e_1m_pair_site_updates_per_sec", ups, "updates/s",
                  "cpu64_updates_per_sec")
    rec["elapsed_s"] = round(warm, 3)
    rec["samples_s"] = [round(t, 3) for t in times]
    return rec


def main_boot() -> dict:
    """Bootstrap-at-scale end-to-end (BASELINE.json config 4 shape
    class: --n_boot_rep 100 --boot_block_size 5): 101 matrices through
    the real CLI pipeline at 1024 x 256k.  The partial-sum tensor would
    be 440 GB at block size 5, so this measures the weighted-replicate
    path: ONE upload of the resident device tensor, then every
    replicate reuses the SAME compiled shape with streamed
    per-site multiplicity weights (no gather, no re-upload) — where the
    reference recomputes 101 full passes (ngsDist.cpp:217-289).
    updates/s counts the reference-equivalent work: n_pairs * (S +
    100 * n_trunc)."""
    import shutil

    sys.path.insert(0, REPO)
    from ngsdist_jax import runner

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_BOOT_SITES", 1 << 18))
    reps, bs = 100, 5
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    geno, gen_time = _get_gp_bin(N, S)
    td = tempfile.mkdtemp(dir=base)
    try:
        pars = _e2e_pars(geno, N, S, os.path.join(td, "out.dist"),
                         n_boot_rep=reps, boot_block_size=bs, seed=5)
        t0 = time.perf_counter()
        runner.run(pars, engine="jax")
        elapsed = time.perf_counter() - t0
    finally:
        shutil.rmtree(td, ignore_errors=True)
    n_trunc = S - S % bs
    updates = (N * (N - 1) / 2) * (S + reps * n_trunc)
    ups = updates / elapsed
    print(f"# bootstrap e2e {N} ind x {S} sites, {reps} reps block {bs}: "
          f"input gen {gen_time:.1f}s, 101 matrices in {elapsed:.1f}s "
          f"(one upload, weighted replicates)", file=sys.stderr)
    rec = _record("boot_e2e_pair_site_updates_per_sec", ups, "updates/s",
                  "cpu64_updates_per_sec")
    rec["elapsed_s"] = round(elapsed, 3)
    rec["n_matrices"] = reps + 1
    return rec


def main_e2e_em() -> dict:
    """EM-path (non-independent genotypes) end-to-end: binary GP file ->
    fused reader -> per-(pair,site) EM -> phylip writer.  Shape 1024 x
    16k: ~8.6e9 EM problems.  Reference path: ngsDist.cpp:348-349 (em2
    per site) under the default !indep_geno."""
    import shutil

    sys.path.insert(0, REPO)
    from ngsdist_jax import runner

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S = int(os.environ.get("NGSDIST_BENCH_EM_E2E_SITES", 1 << 14))
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    geno, gen_time = _get_gp_bin(N, S)
    td = tempfile.mkdtemp(dir=base)
    try:
        times = []
        for it in range(5):
            pars = _e2e_pars(geno, N, S, os.path.join(td, f"out{it}.dist"),
                             indep_geno=False)
            t0 = time.perf_counter()
            runner.run(pars, engine="jax")
            times.append(time.perf_counter() - t0)
            if it >= 2 and _deadline_passed():
                break
    finally:
        shutil.rmtree(td, ignore_errors=True)
    cold, post = times[0], sorted(times[1:])
    warm = post[0]
    med = post[(len(post) - 1) // 2]
    ups = (N * (N - 1) / 2) * S / warm
    print(f"# EM e2e {N} ind x {S} sites: input gen {gen_time:.1f}s, "
          f"pipeline cold {cold:.1f}s / warm min {warm:.1f}s median "
          f"{med:.1f}s", file=sys.stderr)
    rec = _record("em_e2e_pair_site_updates_per_sec", ups, "updates/s",
                  "cpu64_em_updates_per_sec")
    rec["cold_s"] = round(cold, 3)
    rec["warm_s"] = round(warm, 3)
    rec["warm_median_s"] = round(med, 3)
    rec["samples_s"] = [round(t, 3) for t in times]
    rec["parts"] = _em_e2e_attribution(geno, N, S)
    print(f"#   EM e2e parts: {rec['parts']}", file=sys.stderr)
    return rec


def _em_e2e_attribution(geno: str, N: int, S: int) -> dict:
    """Decompose the EM e2e warm wall-time into its pipeline components.
    Each component is timed in isolation at the run's exact shape:
    fused disk read+parse, the host->device upload with a completion
    barrier, the EM statistics on the resident expanded tensor (the
    engine's dispatch), and the %.10f phylip writer.  The
    components overlap in the real pipeline, so warm_s < sum(parts) is
    expected — `overlap_s` records how much the stream actually hid."""
    import jax
    import jax.numpy as jnp

    from ngsdist_jax.config import Params, default_score_matrix
    from ngsdist_jax.core import distance as dist
    from ngsdist_jax.io import readers, writers
    from ngsdist_jax.core.distance import em_pair_stats

    parts = {}
    pars = Params(in_geno=geno, in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, evol_model=1, verbose=0, out="x", seed=1)
    src = readers.PackedBinInput(pars)
    t0 = time.perf_counter()
    buf = src.read_packed(0, S)
    parts["read_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    dbuf = jax.device_put(buf)
    np.asarray(dbuf[:1, :1])
    parts["upload_s"] = round(time.perf_counter() - t0, 3)

    P = dist.expand23(dbuf)
    np.asarray(P[:1, :1])
    score9 = jnp.asarray(default_score_matrix().reshape(-1), jnp.float32)

    def kern():
        raw, cnt = dist.em_pair_stats(P, score9, True)
        return np.asarray(jnp.sum(raw))

    kern()  # compile at THIS shape (cached for later runs)
    t0 = time.perf_counter()
    kern()
    parts["kernel_s"] = round(time.perf_counter() - t0, 3)

    D = np.random.default_rng(0).random((N, N))
    D = np.triu(D, 1) + np.triu(D, 1).T
    labels = [f"Ind_{i}" for i in range(N)]
    outp = os.path.join(tempfile.gettempdir(), "attr.dist")
    t0 = time.perf_counter()
    with open(outp, "w") as fh:
        writers.write_dist_matrix(fh, labels, D)
    parts["writer_s"] = round(time.perf_counter() - t0, 3)
    os.unlink(outp)
    return parts


def main_indep() -> dict:
    """Full-matrix indep sufficient statistics (pairwise deletion) over
    S sites streamed as NGSDIST_BENCH_CHUNK-site chunks through the
    engine's contraction, core/distance.indep_suffstats.  The whole
    chunk loop is one lax.scan dispatch (the body picks one of NBUF
    distinct device-resident chunks by the loop counter, so XLA cannot
    collapse repeated identical calls), timed differentially over two
    chunk counts to cancel the constant dispatch and fetch cost."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from ngsdist_jax.config import default_score_matrix
    from ngsdist_jax.core.distance import indep_suffstats

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
    S_total = int(os.environ.get("NGSDIST_BENCH_N_SITES", 1 << 20))
    chunk = int(os.environ.get("NGSDIST_BENCH_CHUNK", 1 << 16))
    n_chunks = max(1, S_total // chunk)
    S_total = n_chunks * chunk

    dev = jax.devices()[0]
    dtype = jnp.float32
    NBUF = min(4, n_chunks)

    @jax.jit
    def finalize(raw, cnt):
        d = raw / jnp.maximum(cnt, 1)
        d = -jnp.log1p(-d) * (1 - jnp.eye(N, dtype=dtype))
        return jnp.sum(d)

    @functools.partial(jax.jit, static_argnames=("k",))
    def full_matrix(bufs_t, score, k):
        # lax.switch over per-buffer closures, not a gather of a stacked
        # tensor, which would copy a whole chunk per step
        def body(carry, i):
            raw, cnt = carry
            r, c = jax.lax.switch(
                i % NBUF,
                [functools.partial(indep_suffstats, bufs_t[b], score, True)
                 for b in range(NBUF)])
            return (raw + r, cnt + c), 0
        (raw, cnt), _ = jax.lax.scan(
            body, (jnp.zeros((N, N), dtype), jnp.zeros((N, N), dtype)),
            jnp.arange(k, dtype=jnp.int32))
        return finalize(raw, cnt)

    key = jax.random.PRNGKey(0)
    logits = jax.random.normal(key, (NBUF, chunk, N, 3), dtype=dtype)
    P4 = jax.nn.softmax(logits, axis=-1)
    bufs_t = tuple(jax.device_put(P4[b], dev) for b in range(NBUF))
    score = jax.device_put(jnp.asarray(default_score_matrix(), dtype), dev)

    def tmin(k, n=3):
        np.asarray(full_matrix(bufs_t, score, k))  # compile this k
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            np.asarray(full_matrix(bufs_t, score, k))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    k1 = max(1, n_chunks // 4)
    elapsed = tmin(n_chunks + k1) - tmin(k1)  # device time for n_chunks

    n_pairs = N * (N - 1) // 2
    updates = float(n_pairs) * float(S_total)
    rate = updates / elapsed

    print(
        f"# {N} ind x {S_total} sites ({n_chunks} chunks of {chunk}) in "
        f"{elapsed:.3f}s on {dev.platform}:{dev.device_kind}",
        file=sys.stderr,
    )
    return _record("pair_site_updates_per_sec", rate, "updates/s",
                   "cpu64_updates_per_sec")


# e2e1m goes LAST: it is the budget hog (25.8 GB input gen), so any
# mode after it would be skipped whenever it overruns the budget.
_MODES = [("indep", main_indep), ("em", main_em), ("e2e", main_e2e),
          ("e2e_em", main_e2e_em), ("e2e_cg", main_e2e_cg),
          ("boot", main_boot), ("e2e1m", main_e2e_1m)]

# Soft deadline shared with modes that can trim optional extra trials
# (set by main_all from NGSDIST_BENCH_BUDGET; single-mode runs have none).
_DEADLINE: float | None = None


def _deadline_passed() -> bool:
    return _DEADLINE is not None and time.perf_counter() > _DEADLINE


# Per-mode wall-time estimates (seconds, warm input cache), used only
# to decide whether a mode still fits the remaining budget.  Input
# generation is added separately on a cache miss.  Not measured on a
# GPU yet: the benchmark's own design is future work.
_EST_FIXED = {"indep": 90, "em": 40, "e2e": 25, "e2e_em": 70,
              "e2e_cg": 20, "boot": 140, "e2e1m": 140}
_SHAPES = {  # S for the mode — mirrors each main_*
    "e2e": 1 << 16, "e2e_em": 1 << 14, "e2e_cg": 1 << 16,
    "boot": 1 << 18, "e2e1m": 1 << 20,
}
_S_ENV = {"e2e": "NGSDIST_BENCH_N_SITES", "e2e_cg": "NGSDIST_BENCH_N_SITES",
          "e2e_em": "NGSDIST_BENCH_EM_E2E_SITES",
          "boot": "NGSDIST_BENCH_BOOT_SITES", "e2e1m": "NGSDIST_BENCH_1M_SITES"}


def _mode_estimate(name: str) -> float:
    est = float(_EST_FIXED.get(name, 120))
    if name in _SHAPES:
        N = int(os.environ.get("NGSDIST_BENCH_N_IND", 1024))
        S = int(os.environ.get(_S_ENV[name], _SHAPES[name]))
        # generation cost on a cache miss (~65 MB/s)
        path = os.path.join(_cache_dir(), f"gp_{N}x{S}_s7.bin")
        if not (os.path.exists(path) and
                os.path.getsize(path) == S * N * 24):
            est += S * N * 24 / 65e6
    return est


def _emit(results: dict, final: bool = False) -> int:
    """Print the combined JSON line for the modes captured SO FAR.
    Called after every mode (and once at the end): the driver keeps the
    last stdout JSON line, so a run killed at its timeout still leaves
    a parseable record of everything that finished."""
    head = next((results[n] for n, _ in _MODES
                 if "value" in results.get(n, {})), None)
    if head is None:
        print(json.dumps({"metrics": results}), flush=True)
        return 1
    out = dict(head)
    out["metrics"] = {n: r for n, r in results.items()
                      if r.get("metric") != head.get("metric")}
    if not final:
        out["partial"] = True
    print(json.dumps(out), flush=True)
    return 0


def main_all() -> int:
    """Default invocation: every headline metric, one combined JSON line.

    The top-level metric/value/vs_baseline stay the indep headline (the
    contract's north star, BASELINE.json) so consumers of the old
    single-metric format keep working; the other modes land under
    "metrics".  A failing mode is recorded and skipped, not fatal —
    BENCH artifacts should carry whatever the chip gave us."""
    budget = float(os.environ.get("NGSDIST_BENCH_BUDGET", "1100"))
    t_start = time.perf_counter()
    global _DEADLINE
    _DEADLINE = t_start + budget
    results: dict = {}
    for name, fn in _MODES:
        spent = time.perf_counter() - t_start
        est = _mode_estimate(name)
        if spent + est > budget:
            results[name] = {"skipped": f"estimated {est:.0f}s exceeds "
                             f"remaining budget ({budget - spent:.0f}s "
                             f"of {budget:.0f}s)"}
            print(f"# bench: skipping {name} — est {est:.0f}s vs "
                  f"{budget - spent:.0f}s left", file=sys.stderr)
            continue
        try:
            results[name] = fn()
        except Exception as ex:  # isolate: one dead mode != no artifact
            results[name] = {"error": f"{type(ex).__name__}: {ex}"}
            print(f"# bench: {name} mode failed: {ex}", file=sys.stderr)
        _emit(results)
    return _emit(results, final=True)


def _apply_platform() -> None:
    """Honor NGSDIST_BENCH_PLATFORM (e.g. "cpu" for a smoke run), applied
    post-import via jax.config like the CLI's --platform flag."""
    plat = os.environ.get("NGSDIST_BENCH_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


if __name__ == "__main__":
    _apply_platform()
    if "--em" in sys.argv:
        print(json.dumps(main_em()))
    elif "--e2e" in sys.argv:
        print(json.dumps(main_e2e()))
    elif "--e2e1m" in sys.argv:
        print(json.dumps(main_e2e_1m()))
    elif "--e2e_em" in sys.argv:
        print(json.dumps(main_e2e_em()))
    elif "--e2e_cg" in sys.argv:
        print(json.dumps(main_e2e_cg()))
    elif "--boot" in sys.argv:
        print(json.dumps(main_boot()))
    elif "--indep" in sys.argv:
        print(json.dumps(main_indep()))
    else:
        sys.exit(main_all())
