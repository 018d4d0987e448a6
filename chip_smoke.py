#!/usr/bin/env python3
"""Smoke test of ngsdist on NVIDIA GPUs: the CLI's main paths at a
cohort of 1,024 individuals, each checked for correctness.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the multi-device paths only

One card:
  em      EM path (the reference's default): gz Beagle GL text, 1024 x
          16384 sites, ~10% missing, --pairwise_del --evol_model 1.  Run
          with the EM kernel and again with the XLA scan, both timed.
  indep   --indep_geno --pairwise_del on binary GP, 1024 x 65536 sites,
          --n_boot_rep 4 --boot_block_size 1024 --seed 12345 (5 matrices).
  call    --call_geno on the same binary input (the coded uint8 upload).
  kernel  the EM kernel vs em_suffstats at 1024 x 4096 sites, and the
          indep contraction's time and FLOP/s at 1024 x 65536 sites.

Parity without a full CPU run: for models 0-2 a pair's distance depends
only on that pair's data, so the first 64 individuals are cut into a
second input, run on the exact engine (native C, no JAX, in this same
process), and compared with the [:64, :64] block of every GPU matrix,
bootstrap replicates included.

Four cards (--four): the --coordinator path (4 processes, one per card,
launched before this process initializes JAX), then in this process the
1-D site mesh (--devices 4) and the 2-D mesh (--devices 4 --pairs 2),
for the EM and indep paths, each against the result on one card.

The last line of standard output is {"ok": true, "device": {...}}.  The
script exits non-zero without printing it when JAX finds no GPU, when
the repository is not beside it, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# these fail when the script runs without the repository beside it
from ngsdist_jax import cli  # noqa: E402
from ngsdist_jax.config import default_score_matrix  # noqa: E402
from ngsdist_jax.core import distance  # noqa: E402
from ngsdist_jax.ops import em_kernel  # noqa: E402

# Distance tolerances, absolute, f32 device engine vs the f64 exact engine:
# - indep: 5e-6 is the f32 tier of tests/test_fuzz_engines.py, set at
#   S <= 150 sites.  A distance is raw/cnt with raw one f32 accumulation
#   over the 3S-term contraction, whose rounding error random-walks to a
#   relative u*sqrt(3S) (u = 2^-24): 2.6e-5 at S = 65,536, and distances
#   are below 1.  The tolerance is the larger of the two (tol_indep).
# - EM: an f32 EM exit test within ulps of tole=1e-3 can stop a lane one
#   step elsewhere on the loglik plateau, moving that pair by ~1e-4; the
#   JC69 transform (model 2) multiplies it near its pole.
TOL_INDEP_F32 = 5e-6
TOL_EM_F32 = 4e-4  # the phases run --evol_model 1; JC69 (model 2) needs 2e-3


def tol_indep(n_sites: int) -> float:
    return max(TOL_INDEP_F32, 2.0 ** -24 * np.sqrt(3.0 * n_sites))
# Longest a --coordinator process may run before the phase fails.
COORD_TIMEOUT_S = 240
# FP32 rate outside the tensor cores (NVIDIA H100 SXM data sheet).
FP32_PEAK = {"NVIDIA H100 80GB HBM3": 67e12}


@dataclasses.dataclass
class Sizes:
    n_ind: int = 1024
    em_sites: int = 16384
    indep_sites: int = 65536
    kernel_sites: int = 4096
    subset: int = 64
    boot_reps: int = 4
    boot_block: int = 1024
    seed: int = 12345


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ #
# data                                                                 #
# ------------------------------------------------------------------ #


def make_probs(rng, n_sites: int, n_ind: int, missing: float = 0.1):
    """[S, N, 3] float64 genotype probabilities, Dirichlet(1, 1, 1) per
    triple, with a `missing` share of uniform (missing) triples."""
    P = rng.exponential(size=(n_sites, n_ind, 3))
    P /= P.sum(axis=-1, keepdims=True)
    P[rng.random((n_sites, n_ind)) < missing] = 1.0 / 3.0
    return P


def write_beagle_gz(path: str, P, n_ind: int) -> None:
    """The first n_ind individuals of P as gz Beagle GL text: a header,
    then `marker allele1 allele2` and per-triple likelihoods scaled so
    the largest is 1, with 4 decimals (missing triples read 1 1 1)."""
    Q = P[:, :n_ind]
    q = np.rint(Q / Q.max(axis=-1, keepdims=True) * 10000).astype(np.int32)
    q = q.reshape(q.shape[0], -1)
    digits = np.empty(q.shape + (7,), np.uint8)
    digits[..., 0] = ord("0") + q // 10000
    digits[..., 1] = ord(".")
    for k, div in enumerate((1000, 100, 10, 1)):
        digits[..., 2 + k] = ord("0") + (q % 10000) // div % 10
    digits[..., 6] = ord("\t")
    digits[:, -1, 6] = ord("\n")
    header = "marker\tallele1\tallele2\t" + "\t".join(
        f"Ind{i}\tInd{i}\tInd{i}" for i in range(n_ind)) + "\n"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(header.encode())
        for s in range(q.shape[0]):
            f.write(f"chr1_{s + 1}\t0\t1\t".encode())
            f.write(digits[s].tobytes())


def write_bin(path: str, P, n_ind: int) -> None:
    """The first n_ind individuals of P as binary site-major doubles."""
    np.ascontiguousarray(P[:, :n_ind], dtype="<f8").tofile(path)


def make_inputs(workdir: str, sizes: Sizes, four: bool = False) -> dict:
    """Seeded inputs: the EM text and indep binary files at full width,
    plus (one-card mode) their first-`subset`-individual cuts."""
    rng = np.random.default_rng(sizes.seed)
    paths = {"em": os.path.join(workdir, "gl.beagle.gz"),
             "bin": os.path.join(workdir, "gp.bin")}
    P = make_probs(rng, sizes.em_sites, sizes.n_ind)
    write_beagle_gz(paths["em"], P, sizes.n_ind)
    if not four:
        paths["em_sub"] = os.path.join(workdir, "gl_sub.beagle.gz")
        write_beagle_gz(paths["em_sub"], P, sizes.subset)
    del P
    P = make_probs(rng, sizes.indep_sites, sizes.n_ind)
    write_bin(paths["bin"], P, sizes.n_ind)
    if not four:
        paths["bin_sub"] = os.path.join(workdir, "gp_sub.bin")
        write_bin(paths["bin_sub"], P, sizes.subset)
    return paths


# ------------------------------------------------------------------ #
# CLI runs and parity                                                  #
# ------------------------------------------------------------------ #


def phase_args(phase: str, paths: dict, sizes: Sizes, sub: bool = False):
    """CLI arguments of a phase (sub: the subset input and cohort)."""
    n = sizes.subset if sub else sizes.n_ind
    if phase == "em":
        return ["--geno", paths["em_sub" if sub else "em"], "--probs",
                "--n_ind", str(n), "--n_sites", str(sizes.em_sites),
                "--pairwise_del", "--evol_model", "1", "--verbose", "0"]
    boot = ["--n_boot_rep", str(sizes.boot_reps), "--boot_block_size",
            str(sizes.boot_block), "--seed", str(sizes.seed)]
    args = ["--geno", paths["bin_sub" if sub else "bin"], "--probs",
            "--n_ind", str(n),
            "--n_sites", str(sizes.indep_sites), "--indep_geno",
            "--pairwise_del", "--verbose", "0"] + boot
    if phase == "call":
        args.append("--call_geno")
    return args


def run_cli(args, out: str) -> float:
    """One in-process CLI run (python -m ngsdist_jax); wall seconds."""
    t = time.perf_counter()
    rc = cli.main(list(args) + ["--out", out])
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}: {' '.join(args)}")
    return time.perf_counter() - t


def read_dist(path: str):
    """The matrices of a .dist output file (phylip blocks)."""
    with open(path) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    mats, k = [], 0
    while k < len(lines):
        n = int(lines[k])
        rows = [ln.split("\t")[1:] for ln in lines[k + 1:k + 1 + n]]
        mats.append(np.array(rows, dtype=np.float64).reshape(n, n))
        k += 1 + n
    return mats


def subset_parity(full, sub) -> float:
    """Largest |difference| between the leading block of each matrix in
    `full` and the matching matrix of `sub` (the same run on a cut of
    the first individuals).  NaN positions must agree."""
    if len(full) != len(sub):
        raise AssertionError(f"{len(full)} matrices vs {len(sub)}")
    worst = 0.0
    for a, b in zip(full, sub):
        k = b.shape[0]
        blk = a[:k, :k]
        if not np.array_equal(np.isnan(blk), np.isnan(b)):
            where = np.argwhere(np.isnan(blk) != np.isnan(b))
            raise AssertionError(
                f"NaN positions differ: {int(np.isnan(blk).sum())} NaN in "
                f"the device block, {int(np.isnan(b).sum())} in the "
                f"reference; first at {where[:4].tolist()}")
        ok = ~np.isnan(b)
        if ok.any():
            worst = max(worst, float(np.max(np.abs(blk[ok] - b[ok]))))
    return worst


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max |d - d_ref| = {err:.3e} (tolerance {tol:.2e})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.2e}")


@contextlib.contextmanager
def xla_scan_only():
    """Route the EM path through the XLA scan instead of the kernel."""
    orig = distance.use_em_kernel
    distance.use_em_kernel = lambda dtype: False
    try:
        yield
    finally:
        distance.use_em_kernel = orig


def run_parity_phases(workdir: str, sizes: Sizes, paths: dict) -> dict:
    """The em, indep and call phases with their subset parity checks."""
    threads = str(os.cpu_count() or 1)
    report = {}
    for phase in ("em", "indep", "call"):
        out = os.path.join(workdir, f"{phase}.dist")
        ref = os.path.join(workdir, f"{phase}_exact.dist")
        wall = run_cli(phase_args(phase, paths, sizes), out)
        log(f"phase {phase}: device run {wall:.2f} s")
        t_ref = run_cli(phase_args(phase, paths, sizes, sub=True)
                        + ["--engine", "exact", "--n_threads", threads], ref)
        log(f"phase {phase}: exact engine on {sizes.subset} individuals "
            f"{t_ref:.2f} s")
        got, want = read_dist(out), read_dist(ref)
        tol = TOL_EM_F32 if phase == "em" else tol_indep(sizes.indep_sites)
        err = subset_parity(got, want)
        check(f"{phase} ({len(got)} matrices)", err, tol)
        report[phase] = {"wall_s": wall, "err": err, "tol": tol}
        if phase == "em":
            with xla_scan_only():
                wall_x = run_cli(phase_args(phase, paths, sizes),
                                 out + ".scan")
            err_x = subset_parity(read_dist(out + ".scan"), want)
            log(f"phase em (XLA scan instead of the kernel): device run "
                f"{wall_x:.2f} s")
            check("em, XLA scan", err_x, TOL_EM_F32)
            report["em_scan"] = {"wall_s": wall_x, "err": err_x,
                                 "tol": TOL_EM_F32}
    return report


# ------------------------------------------------------------------ #
# kernel timings                                                       #
# ------------------------------------------------------------------ #


def _best_time(fn, reps: int):
    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t)
    return out, best


def kernel_vs_scan(n_ind: int, n_sites: int, seed: int,
                   interpret: bool = False, reps: int = 3) -> dict:
    """The EM kernel and em_suffstats on the same float32 data: best
    wall times and the largest distance difference (pairwise deletion,
    raw p-distance)."""
    rng = np.random.default_rng(seed)
    P = jnp.asarray(make_probs(rng, n_sites, n_ind).astype(np.float32))
    score9 = jnp.asarray(default_score_matrix().reshape(-1), jnp.float32)
    kern = jax.jit(functools.partial(em_kernel.em_raw_cnt, score9=score9,
                                     pairwise_del=True, interpret=interpret))
    (raw_k, cnt_k), t_k = _best_time(lambda: kern(P), reps)
    (raw_s, cnt_s, _, _), t_s = _best_time(
        lambda: distance.em_suffstats(P, score9, True), 1)
    iu = np.triu_indices(n_ind, k=1)
    d_k = np.asarray(raw_k, np.float64)[iu] / np.asarray(cnt_k, np.float64)[iu]
    d_s = np.asarray(raw_s, np.float64) / np.asarray(cnt_s, np.float64)
    return {"kernel_s": t_k, "scan_s": t_s,
            "dist_max_abs": float(np.max(np.abs(d_k - d_s))),
            "memory": None if interpret else
            kern.lower(P).compile().memory_analysis()}


def indep_contraction(n_ind: int, n_sites: int, seed: int) -> dict:
    """indep_suffstats (raw and counts, pairwise deletion) at float32."""
    rng = np.random.default_rng(seed)
    P = jnp.asarray(make_probs(rng, n_sites, n_ind).astype(np.float32))
    score = jnp.asarray(default_score_matrix(), jnp.float32)
    _, t = _best_time(lambda: distance.indep_suffstats(P, score, True), 5)
    # [N, 3S] x [3S, N] for raw plus [N, S] x [S, N] for the counts
    flops = 2.0 * n_ind * n_ind * 4 * n_sites
    mem = distance.indep_suffstats.lower(P, score, True).compile() \
        .memory_analysis()
    return {"s": t, "flops": flops, "flop_s": flops / t, "memory": mem}


def run_kernel_phase(sizes: Sizes, kind: str) -> dict:
    em = kernel_vs_scan(sizes.n_ind, sizes.kernel_sites, sizes.seed)
    log(f"kernel: EM kernel {em['kernel_s'] * 1e3:.2f} ms, em_suffstats "
        f"(XLA) {em['scan_s'] * 1e3:.1f} ms at {sizes.n_ind} x "
        f"{sizes.kernel_sites} sites ({em['scan_s'] / em['kernel_s']:.0f}x)")
    check("kernel vs em_suffstats", em["dist_max_abs"], TOL_EM_F32)
    log(f"kernel: EM kernel memory_analysis {em['memory']}")
    ind = indep_contraction(sizes.n_ind, sizes.indep_sites, sizes.seed)
    peak = FP32_PEAK.get(kind)
    share = (f"{ind['flop_s'] / peak:.1%} of the {peak / 1e12:.0f} TFLOP/s "
             f"FP32 peak" if peak else f"no FP32 peak on file for {kind}")
    log(f"kernel: indep contraction {ind['s'] * 1e3:.2f} ms at "
        f"{sizes.n_ind} x {sizes.indep_sites} sites, "
        f"{ind['flop_s'] / 1e12:.2f} TFLOP/s ({share})")
    log(f"kernel: indep contraction memory_analysis {ind['memory']}")
    return {"em": em, "indep": ind}


# ------------------------------------------------------------------ #
# four cards                                                           #
# ------------------------------------------------------------------ #


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_coordinator(phase: str, paths: dict, sizes: Sizes, workdir: str,
                    n_proc: int) -> tuple:
    """The --coordinator path: one process per card, each bound to its
    own card.  Returns (output path, wall seconds)."""
    out = os.path.join(workdir, f"{phase}_coord.dist")
    addr = f"localhost:{_free_port()}"
    procs, logs = [], []
    t = time.perf_counter()
    try:
        for k in range(n_proc):
            lf = open(os.path.join(workdir, f"{phase}_coord_{k}.log"), "w")
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ngsdist_jax",
                 *phase_args(phase, paths, sizes), "--out", out,
                 "--platform", "gpu", "--coordinator", addr,
                 "--num_processes", str(n_proc), "--process_id", str(k),
                 "--local_device_ids", str(k)],
                cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONFAULTHANDLER="1")))
        rcs = [p.wait(timeout=COORD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
    wall = time.perf_counter() - t
    if any(rcs):
        tails = []
        for k in range(n_proc):
            with open(os.path.join(workdir, f"{phase}_coord_{k}.log")) as f:
                tails.append(f"--- process {k}:\n" + f.read()[-3000:])
        raise RuntimeError(f"--coordinator {phase}: exit codes {rcs}\n"
                           + "\n".join(tails))
    return out, wall


def run_four(workdir: str, sizes: Sizes, paths: dict, n_dev: int = 4) -> dict:
    """Multi-device paths against the one-card result.  The coordinator
    processes run (and exit) before this process touches a device."""
    report, coord, failed = {}, {}, []
    for phase in ("em", "indep"):
        try:
            coord[phase], wall = run_coordinator(phase, paths, sizes,
                                                 workdir, n_dev)
        except RuntimeError as e:  # the in-process phases still run
            log(f"four {phase} --coordinator FAILED: {e}")
            failed.append(f"{phase} --coordinator")
            continue
        log(f"four {phase} --coordinator ({n_dev} processes): {wall:.2f} s")
    devices = gpu_devices()
    if len(devices) < n_dev:
        raise RuntimeError(f"--four needs {n_dev} devices, found "
                           f"{len(devices)}")
    for phase in ("em", "indep"):
        tol = TOL_EM_F32 if phase == "em" else tol_indep(sizes.indep_sites)
        one = os.path.join(workdir, f"{phase}_one.dist")
        wall = run_cli(phase_args(phase, paths, sizes), one)
        log(f"four {phase} one card: {wall:.2f} s")
        ref = read_dist(one)
        runs = {"coordinator": coord[phase]} if phase in coord else {}
        for name, extra in (("1-D mesh", ["--devices", str(n_dev)]),
                            ("2-D mesh", ["--devices", str(n_dev),
                                          "--pairs", "2"])):
            out = os.path.join(workdir, f"{phase}_{name[:3]}.dist")
            wall = run_cli(phase_args(phase, paths, sizes) + extra, out)
            log(f"four {phase} {name}: {wall:.2f} s")
            runs[name] = out
        for name, out in runs.items():
            err = subset_parity(read_dist(out), ref)
            check(f"four {phase} {name} vs one card", err, tol)
            report[f"{phase} {name}"] = err
    if failed:
        raise RuntimeError(f"failed: {', '.join(failed)}")
    return report


# ------------------------------------------------------------------ #
# entry                                                                #
# ------------------------------------------------------------------ #


def gpu_devices():
    """The JAX devices, which must be GPUs (no fallback to the CPU)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found "
                         f"{devices[0].platform} devices)")
    return devices


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card paths (and nothing else)")
    args = ap.parse_args(argv)
    sizes = Sizes()
    if not args.four:  # --four first runs processes that hold the cards
        devices = gpu_devices()
    workdir = os.path.join(ROOT, ".smoke_data")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        if args.four:
            t = time.perf_counter()
            paths = make_inputs(workdir, sizes, four=True)
            log(f"data: {time.perf_counter() - t:.2f} s")
            run_four(workdir, sizes, paths)
            devices = gpu_devices()
        else:
            log(f"jax {jax.__version__}, device {devices[0].device_kind}")
            t = time.perf_counter()
            paths = make_inputs(workdir, sizes)
            log(f"data: {time.perf_counter() - t:.2f} s")
            run_parity_phases(workdir, sizes, paths)
            run_kernel_phase(sizes, devices[0].device_kind)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(card_info())
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
