#!/usr/bin/env python
"""Scaling-efficiency harness: sharded engine over 1..n-device meshes,
plus a MEASURED collective-overhead model for multi-host claims.

The SURVEY.md build plan calls for a 1-chip / 1-host / N-host scaling
report (§7 step 5).  This harness runs the mesh-sharded independent-path
sufficient statistics over growing device meshes and reports pair-site
updates/sec and parallel efficiency per mesh size, one JSON line each.

On a multi-GPU host the collectives ride NVLink (NCCL) and the numbers
are real scaling; on a single host this can also demonstrate the sharding
with virtual devices (NGSDIST_SCALING_FORCE_CPU=1 forces an 8-way
virtual CPU mesh — functional, not a performance statement).

## Collective overhead (the quantitative scale-out evidence)

Multi-chip hardware cannot be conjured on this rig, so the ≥2-host
efficiency claim is carried by a measured MODEL:

  The engine's ONLY steady-state communication is one psum of the
  per-round sufficient statistics: payload_bytes = 2*N^2*4 (indep,
  raw+cnt f32) or 2*n_pairs*4 (EM) per device per round — everything
  else (input reads) is per-host-local.  Round efficiency is then

      eff(s_dev) = T_comp(s_dev) / (T_comp(s_dev) + T_coll)
      T_comp(s_dev) = s_dev * n_pairs / R_dev

  with R_dev the measured single-chip kernel rate and T_coll = lat +
  payload/bw for the transport.  The 80%-efficiency crossover is
  s_min = 4 * T_coll * R_dev / n_pairs sites/device/round.

`--collectives` measures T_coll(b) on a REAL 2-process
jax.distributed runtime over localhost TCP (latency + bandwidth fit
across payload sizes), validates the model against the actual
2-process engine round loop (predicted vs measured per-round cost).
The crossover s_min needs R_dev, the single-card rate, measured on
the card itself.

Usage: python bench_scaling.py [--collectives]  [env:
NGSDIST_BENCH_N_IND, NGSDIST_BENCH_N_SITES shape knobs]
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

_COLL_WORKER = r"""
import os, sys, time, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, %(repo)r)
jax.distributed.initialize("127.0.0.1:" + port, num_processes=2,
                           process_id=pid)
import numpy as np
import jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

mesh = Mesh(np.array(jax.devices()), ("sites",))

@jax.jit
@partial(shard_map, mesh=mesh, in_specs=P("sites"), out_specs=P())
def allred(x):
    return jax.lax.psum(x, "sites")

def t_psum(n_f32, reps):
    local = np.random.default_rng(pid).random((1, n_f32), np.float32)
    x = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("sites")), local, (2, n_f32))
    np.asarray(allred(x))  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _r in range(reps):
            y = allred(x)
        np.asarray(y)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best

sizes = [1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22]  # f32 counts
rows = [(n, t_psum(n, 10)) for n in sizes]

# engine rounds at two N: the real per-round collective path
# (sharded_suffstats psum of raw+cnt) on a tiny compute chunk.  The
# payload scales 2*N^2*4 while dispatch overhead stays fixed, so the
# DELTA between the two isolates the collective term for validation
# against the psum fit; the residual at the small N is the fixed
# per-round dispatch cost.
from ngsdist_jax.config import default_score_matrix
from ngsdist_jax.parallel import mesh as pm
score = default_score_matrix()
S = 64  # tiny: compute ~0, round cost ~ collective+dispatch

def engine_round_best(N):
    local = np.random.default_rng(1 + pid).dirichlet(
        np.ones(3), size=(S // 2, N)).astype(np.float32)
    Pd = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("sites", None, None)), local, (S, N, 3))
    def round_once():
        raw, cnt, _, _ = pm.sharded_suffstats(
            Pd, score, mesh, indep=True, pairwise_del=True,
            dtype=jnp.float32, n_sites=S)
        # scalar completion barrier: keep the [N,N] result fetch out of
        # the timed round (it is not part of steady-state streaming)
        np.asarray(raw[0, 0]); np.asarray(cnt[0, 0])
    round_once()  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _r in range(5):
            round_once()
        best = min(best, (time.perf_counter() - t0) / 5)
    return best

engine = {N: engine_round_best(N) for N in (256, 1024)}

# COMPUTE-FREE round variant: exactly the engine
# round's collective op sequence — TWO [N, N] psums (raw + cnt) behind
# one jitted shard_map with a scalar barrier — but on pre-made device
# arrays, no einsum.  The N=1024 vs N=256 delta then isolates the
# payload slope with no N^2 compute riding along.
def psum_round_best(N):
    local = np.random.default_rng(2 + pid).random((1, N, N), np.float32)
    x = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("sites", None, None)), local, (2, N, N))

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P("sites", None, None),
             out_specs=(P(), P()))
    def two_psums(v):
        a = jax.lax.psum(v[0], "sites")
        b = jax.lax.psum(v[0] * 0.5, "sites")
        return a, b

    def round_once():
        a, b = two_psums(x)
        np.asarray(a[0, 0]); np.asarray(b[0, 0])

    round_once()  # compile
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _r in range(10):
            round_once()
        best = min(best, (time.perf_counter() - t0) / 10)
    return best

# five sizes: {128, 512, 896} feed the latency+bandwidth fit, the held
# out {256, 1024} delta validates it (same op family, no circularity).
# TWO interleaved passes with a per-size min decorrelate the slow drift
# of this shared-core localhost transport from the size axis.
psum_sizes = (128, 256, 512, 896, 1024)
psum_round = {N: psum_round_best(N) for N in psum_sizes}
for N in psum_sizes:
    psum_round[N] = min(psum_round[N], psum_round_best(N))

if pid == 0:
    with open(out, "w") as fh:
        json.dump({"psum": rows,
                   "engine_round_s": {str(k): v for k, v in engine.items()},
                   "psum_round_s": {str(k): v
                                    for k, v in psum_round.items()}},
                  fh)
print("OK", pid)
"""


def main() -> None:
    if os.environ.get("NGSDIST_SCALING_FORCE_CPU") == "1":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    if os.environ.get("NGSDIST_SCALING_FORCE_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import jax.numpy as jnp

    from jax.sharding import NamedSharding, PartitionSpec as PS

    from ngsdist_jax.config import default_score_matrix
    from ngsdist_jax.parallel import make_mesh, sharded_suffstats
    from ngsdist_jax.parallel.mesh import AXIS

    N = int(os.environ.get("NGSDIST_BENCH_N_IND", 256))
    S = int(os.environ.get("NGSDIST_BENCH_N_SITES", 1 << 17))

    rng = np.random.default_rng(0)
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float32)
    score = default_score_matrix()
    updates = (N * (N - 1) / 2) * S

    def measure(mesh):
        """Time the engine with the tensor pre-placed on the mesh: the
        metric is compute + collectives, not the host->device copy."""
        sharding = NamedSharding(mesh, PS(AXIS, None, None))
        Pd = jax.device_put(jnp.asarray(P), sharding)
        args = dict(indep=True, pairwise_del=True, dtype=jnp.float32,
                    n_sites=S)
        raw, *_ = sharded_suffstats(Pd, score, mesh, **args)
        _ = np.asarray(raw)  # warm / compile
        times = []
        for _i in range(3):
            t0 = time.perf_counter()
            for _r in range(4):
                raw, *_ = sharded_suffstats(Pd, score, mesh, **args)
            # scalar completion barrier: no [N,N] fetch in the window
            _ = np.asarray(raw[0, 0])
            times.append((time.perf_counter() - t0) / 4)
        return updates / min(times)

    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    base_rate = None
    for nd in sizes:
        if S % nd:
            continue
        rate = measure(make_mesh(n_devices=nd))
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "metric": "pair_site_updates_per_sec",
            "devices": nd,
            "value": rate,
            "unit": "updates/s",
            "efficiency_vs_1dev": rate / (base_rate * nd),
        }))

    # 2-D (sites, pairs) meshes: the optional TP axis for large cohorts
    # (SURVEY.md §2.3 TP row) — report the same metric per factorization.
    for nd in sizes:
        if nd < 2:
            continue
        for p in (2, 4):
            if nd % p or p > nd or S % (nd // p):
                continue
            rate = measure(make_mesh(n_devices=nd, pairs=p))
            print(json.dumps({
                "metric": "pair_site_updates_per_sec",
                "devices": nd,
                "mesh": {"sites": nd // p, "pairs": p},
                "value": rate,
                "unit": "updates/s",
                "efficiency_vs_1dev": rate / (base_rate * nd),
            }))


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main_collectives() -> None:
    """Measured collective-overhead model (module docstring)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "w.py")
        with open(worker, "w") as fh:
            fh.write(_COLL_WORKER % {"repo": REPO})
        outp = os.path.join(td, "out.json")
        port = str(_free_port())
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        procs = [subprocess.Popen([sys.executable, worker, str(p), port, outp],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env,
                                  text=True)
                 for p in (0, 1)]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode:
                print(f"# collectives worker failed:\n{out[-1500:]}",
                      file=sys.stderr)
                return
        with open(outp) as fh:
            got = json.load(fh)

    # latency + bandwidth fit: T(b) = lat + b / bw over the psum sizes
    sizes_b = np.array([n * 4 for n, _ in got["psum"]], float)
    times = np.array([t for _, t in got["psum"]], float)
    A = np.vstack([np.ones_like(sizes_b), sizes_b]).T
    (lat, inv_bw), *_ = np.linalg.lstsq(A, times, rcond=None)
    bw = 1.0 / inv_bw if inv_bw > 0 else float("inf")

    # Model validation on the payload SLOPE: engine rounds at N=256 and
    # N=1024 share identical dispatch overhead (same op sequence, tiny
    # S=64 compute), so measured(N=1024) - measured(N=256) should equal
    # the psum-fit cost of the extra 2*(1024^2-256^2)*4 payload bytes.
    # The residual at N=256 beyond its collective term is the fixed
    # per-round dispatch cost, which the crossover must also carry.
    eng = {int(k): float(v) for k, v in got["engine_round_s"].items()}
    payload = {n: 2 * n * n * 4 for n in eng}  # raw+cnt f32 psum
    d_meas = eng[1024] - eng[256]
    d_pred = (payload[1024] - payload[256]) / bw
    slope_err = abs(d_pred - d_meas) / max(d_meas, 1e-12)
    # Primary validation: COMPUTE-FREE psum rounds
    # — the round's exact collective op sequence (two [N,N] psums, one
    # jitted shard_map) with no einsum.  The latency+bandwidth model is
    # fitted on N in {128, 512, 896} and validated on the HELD-OUT
    # N=256 -> 1024 payload delta, so fit and validation share the op
    # family (the single-vector psum fit above mispredicts the paired
    # round's effective bandwidth by ~25% on this transport) but not
    # the data points.
    pr = {int(k): float(v) for k, v in got["psum_round_s"].items()}
    fitN = [n for n in (128, 512, 896) if n in pr]
    rb = np.array([2 * n * n * 4 for n in fitN], float)
    rt = np.array([pr[n] for n in fitN], float)
    Ar = np.vstack([np.ones_like(rb), rb]).T
    (r_int, r_inv_bw), *_ = np.linalg.lstsq(Ar, rt, rcond=None)
    r_bw = 1.0 / r_inv_bw if r_inv_bw > 0 else float("inf")
    d_meas_cf = pr[1024] - pr[256]
    d_pred_cf = (payload[1024] - payload[256]) / r_bw
    slope_err_cf = abs(d_pred_cf - d_meas_cf) / max(d_meas_cf, 1e-12)
    # the fitted intercept is the whole per-round fixed cost
    # (dispatch + both psum latencies) — exactly what the crossover
    # needs as its constant term
    dispatch = max(0.0, float(r_int))

    rec = {
        "metric": "collective_overhead_model",
        "psum_fit": {"latency_s": float(lat), "bandwidth_Bps": float(bw)},
        "psum_samples": [[int(n * 4), float(t)] for n, t in got["psum"]],
        "psum_round_validation": {
            "round_s_by_N": pr,
            "fit_on_N": fitN,
            "round_fit": {"intercept_s": float(r_int),
                          "bandwidth_Bps": float(r_bw)},
            "payload_delta_bytes": payload[1024] - payload[256],
            "predicted_delta_s": float(d_pred_cf),
            "measured_delta_s": float(d_meas_cf),
            "slope_rel_error": float(slope_err_cf),
            "fixed_dispatch_s": float(dispatch),
            "note": "compute-free variant of the engine round: two "
                    "[N,N] psums behind one jitted shard_map, no "
                    "einsum; model fitted on N in fit_on_N, validated "
                    "on the held-out 256->1024 payload delta",
        },
        "engine_round_validation": {
            "round_s_by_N": eng,
            "payload_delta_bytes": payload[1024] - payload[256],
            "predicted_delta_s": float(d_pred),
            "measured_delta_s": float(d_meas),
            "slope_rel_error": float(slope_err),
            "note": "SECONDARY (conservative) check: the real round "
                    "also carries its N^2-scaling einsum compute "
                    "(S=64) on shared CPU cores, so predicted <= "
                    "measured by construction",
        },
        "formula": "s_min = 4*(dispatch + lat + 2*N^2*4/bw)*R_dev/n_pairs; "
                   "eff(s_dev) = 1/(1 + T_coll/T_comp)",
    }
    print(json.dumps(rec))



if __name__ == "__main__":
    if "--collectives" in sys.argv:
        main_collectives()
    else:
        main()
        main_collectives()
