"""run_distributed end-to-end: 2 processes, full pipeline with bootstrap.

Process 0's output file must match a single-process jax-engine run of
the same configuration numerically (float64 CPU; formatted output is
compared with a tolerance-parse since reduction orders differ at shard
boundaries)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64",
                  os.environ.get("NGSDIST_TEST_X64", "1") == "1")

pid, nproc, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, {repo!r})
from ngsdist_jax.config import Params
from ngsdist_jax.parallel.multihost import run_distributed

# test hook: hard-exit (no cleanup, like SIGKILL) at the Nth sharded
# suffstats call — deterministic mid-replicate crash for round-ckpt
# resume tests (collectives are lockstep, so every process hits the
# same call index together)
_crash_after = int(os.environ.get("NGSDIST_TEST_CRASH_AFTER", "0"))
if _crash_after:
    from ngsdist_jax.parallel import mesh as _pm

    _calls = {{"n": 0}}
    _orig_ss = _pm.sharded_suffstats

    def _spy(*a, **k):
        _calls["n"] += 1
        if _calls["n"] == _crash_after:
            os._exit(17)
        return _orig_ss(*a, **k)

    _pm.sharded_suffstats = _spy

pdel = sys.argv[5] == "1"
evol = int(sys.argv[6]) if len(sys.argv) > 6 else 1
pos = sys.argv[7] if len(sys.argv) > 7 and sys.argv[7] != "-" else None
resume = len(sys.argv) > 8 and sys.argv[8] == "1"
indep = len(sys.argv) > 9 and sys.argv[9] == "1"
geno = sys.argv[10] if len(sys.argv) > 10 else "gp.bin"
pars = Params(in_geno=os.path.join(workdir, geno),
              in_bin=not geno.endswith(".gz"),
              in_probs=True, n_ind=6, n_sites=57, seed=9,
              n_boot_rep=3, boot_block_size=5, pairwise_del=pdel,
              evol_model=evol, in_pos=pos, indep_geno=indep,
              call_geno=os.environ.get("NGSDIST_TEST_CALL_GENO", "0") == "1",
              out=os.path.join(workdir, "mh.dist"), verbose=0)
mats = run_distributed(pars, coordinator="127.0.0.1:" + port,
                       num_processes=nproc, process_id=pid, resume=resume)
print("OK", pid, len(mats))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load(path):
    mats, cur = [], None
    for line in open(path):
        t = line.split("\t")
        if len(t) > 1:
            cur.append([float(x) for x in t[1:]])
        elif line.strip().isdigit():
            cur = []
            mats.append(cur)
    return [np.array(m) for m in mats]


@pytest.mark.slow
@pytest.mark.parametrize("pairwise_del,streamed",
                         [(True, False), (False, False), (True, True),
                          (True, "lazy"), (True, "indep_stream"),
                          (True, "spill")])
def test_run_distributed_two_processes(tmp_path, pairwise_del, streamed):
    """pairwise_del=False is the regression case for the prebuilt-array
    padding bug: padded sites must not count toward the EM statistics.
    streamed=True forces NGSDIST_DEVICE_BUDGET tiny so run_distributed
    iterates SiteStream rounds on every process.  streamed='spill': a
    gz-TEXT genome over the host budget — every process spills its own
    site range to a disk cache and rounds read the cache."""
    import gzip

    rng = np.random.default_rng(13)
    gp = rng.dirichlet(np.ones(3), size=(57, 6))
    gp[rng.random((57, 6)) < 0.15] = 1 / 3
    geno = "gp.bin"
    if streamed == "spill":
        geno = "gp.tsv.gz"
        with gzip.open(tmp_path / geno, "wt") as fh:
            for s in range(57):
                fh.write("\t".join(f"{x:.8f}" for x in gp[s].reshape(-1))
                         + "\n")
    else:
        gp.tofile(str(tmp_path / "gp.bin"))

    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "NGSDIST_DEVICE_BUDGET")}
    if streamed:
        env["NGSDIST_DEVICE_BUDGET"] = str(5 * 6 * 3 * 8)  # ~5 sites/round
    if streamed in ("lazy", "spill"):  # rounds from disk, no host shard
        env["NGSDIST_HOST_BUDGET"] = "1000"
    if streamed == "spill":
        spill_dir = tmp_path / "spill"
        spill_dir.mkdir()
        env["NGSDIST_SPILL_DIR"] = str(spill_dir)
    indep = streamed == "indep_stream"  # single-pass block-partials path
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path),
             "1" if pairwise_del else "0", "1", "-", "0",
             "1" if indep else "0", geno],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    if streamed == "spill":  # every process deleted its cache
        assert list((tmp_path / "spill").iterdir()) == []

    # single-process reference run (jax engine, same config)
    from ngsdist_jax import runner
    from ngsdist_jax.config import Params

    pars = Params(in_geno=str(tmp_path / geno),
                  in_bin=not geno.endswith(".gz"),
                  in_probs=True, n_ind=6, n_sites=57, seed=9,
                  n_boot_rep=3, boot_block_size=5, pairwise_del=pairwise_del,
                  indep_geno=indep,
                  out=str(tmp_path / "single.dist"), verbose=0)
    runner.run(pars, engine="jax")

    mh = _load(str(tmp_path / "mh.dist"))
    single = _load(str(tmp_path / "single.dist"))
    assert len(mh) == len(single) == 4
    for a, b in zip(mh, single):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_run_distributed_extended_model(tmp_path):
    """--evol_model 6 (TN93) over 2 processes: the sharded extended path
    (class-masked stats + sharded base frequencies) must match the
    single-process jax run, incl. bootstrap replicates."""
    rng = np.random.default_rng(17)
    gp = rng.dirichlet(np.ones(3) * 5, size=(57, 6))
    gp[rng.random((57, 6)) < 0.1] = 1 / 3
    gp.tofile(str(tmp_path / "gp.bin"))
    bases = "ACGT"
    pos = str(tmp_path / "pos.txt")
    with open(pos, "w") as fh:
        for s in range(57):
            b = rng.choice(4, size=2, replace=False)
            fh.write(f"chr1\t{s+1}\t{bases[b[0]]}\t{bases[b[1]]}\n")

    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path),
             "1", "6", pos],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    from ngsdist_jax import runner
    from ngsdist_jax.config import Params

    pars = Params(in_geno=str(tmp_path / "gp.bin"), in_bin=True,
                  in_probs=True, n_ind=6, n_sites=57, seed=9,
                  n_boot_rep=3, boot_block_size=5, pairwise_del=True,
                  evol_model=6, in_pos=pos,
                  out=str(tmp_path / "single.dist"), verbose=0)
    runner.run(pars, engine="jax")

    mh = _load(str(tmp_path / "mh.dist"))
    single = _load(str(tmp_path / "single.dist"))
    assert len(mh) == len(single) == 4
    for a, b in zip(mh, single):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_run_distributed_resume(tmp_path):
    """Kill-and-resume durability: a run interrupted after 2 of 4
    matrices, restarted with resume=True, must produce byte-identical
    output to an uninterrupted run — and the resumed run must SKIP the
    durable replicates (asserted via each process's reported count)."""
    rng = np.random.default_rng(23)
    gp = rng.dirichlet(np.ones(3), size=(57, 6))
    gp.tofile(str(tmp_path / "gp.bin"))
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}

    def launch(resume):
        port = str(_free_port())
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", port, str(tmp_path),
                 "0", "1", "-", "1" if resume else "0"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True,
            )
            for pid in range(2)
        ]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        return outs

    launch(resume=False)
    full = open(tmp_path / "mh.dist").read()

    # Simulate an interruption after 2 matrices: truncate the output and
    # plant a matching sidecar (what the graceful-stop path leaves).
    from ngsdist_jax.config import Params
    from ngsdist_jax.utils import checkpoint as ckpt

    lines = full.splitlines(keepends=True)
    per_matrix = 6 + 2  # blank + count + n_ind rows
    with open(tmp_path / "mh.dist", "w") as fh:
        fh.writelines(lines[: 2 * per_matrix])
    pars = Params(in_geno=str(tmp_path / "gp.bin"), in_bin=True,
                  in_probs=True, n_ind=6, n_sites=57, seed=9,
                  n_boot_rep=3, boot_block_size=5,
                  out=str(tmp_path / "mh.dist"), verbose=0)
    pars.validate(); pars.finalize()
    # fingerprint embeds the numeric environment; the workers run the
    # jax engine on cpu/x64 — same as this conftest-pinned process
    ckpt.save(str(tmp_path / "mh.dist"), pars, 2, engine="jax")

    outs = launch(resume=True)
    assert open(tmp_path / "mh.dist").read() == full
    # the writer reports only the 2 newly computed matrices
    assert any("OK 0 2" in o for o in outs), outs


@pytest.mark.slow
def test_run_distributed_f32_streamed(tmp_path):
    """x64-OFF 2-process run — the device numeric regime: f32 engine
    dtype, upload23 auto-ON (2-component SiteStream slabs + on-device
    expansion, PAD23 sentinels on round tails), streamed rounds with
    round checkpoints.  Must match a single-process f32 run at f32
    tolerance (reduction orders differ at shard boundaries)."""
    import jax

    rng = np.random.default_rng(29)
    gp = rng.dirichlet(np.ones(3), size=(57, 6))
    gp[rng.random((57, 6)) < 0.15] = 1 / 3
    gp.tofile(str(tmp_path / "gp.bin"))
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "NGSDIST_DEVICE_BUDGET")}
    env["NGSDIST_TEST_X64"] = "0"
    env["NGSDIST_DEVICE_BUDGET"] = str(5 * 6 * 3 * 8)  # ~5 sites/round
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path),
             "1", "1", "-", "0", "0", "gp.bin"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    from ngsdist_jax import runner
    from ngsdist_jax.config import Params

    jax.config.update("jax_enable_x64", False)
    try:
        pars = Params(in_geno=str(tmp_path / "gp.bin"), in_bin=True,
                      in_probs=True, n_ind=6, n_sites=57, seed=9,
                      n_boot_rep=3, boot_block_size=5, pairwise_del=True,
                      out=str(tmp_path / "single.dist"), verbose=0)
        runner.run(pars, engine="jax")
    finally:
        jax.config.update("jax_enable_x64", True)

    mh = _load(str(tmp_path / "mh.dist"))
    single = _load(str(tmp_path / "single.dist"))
    assert len(mh) == len(single) == 4
    for a, b in zip(mh, single):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.slow
def test_run_distributed_f32_round_ckpt_crash_resume(tmp_path):
    """Round-checkpoint resume across REAL processes under x64-off: crash
    both workers mid-replicate (hard exit at a lockstep suffstats call),
    resume, and require the output byte-identical to an uninterrupted
    run.  This is the end-to-end regression for the f64-accumulator
    broadcast: resume broadcasts host-f64 sums of f32 rounds from
    process 0, and a dtype-truncating broadcast flips output digits."""
    rng = np.random.default_rng(31)
    gp = rng.dirichlet(np.ones(3), size=(57, 6))
    gp[rng.random((57, 6)) < 0.15] = 1 / 3
    gp.tofile(str(tmp_path / "gp.bin"))
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "NGSDIST_DEVICE_BUDGET")}
    base_env["NGSDIST_TEST_X64"] = "0"
    base_env["NGSDIST_DEVICE_BUDGET"] = str(5 * 6 * 3 * 8)  # ~3 rounds/rep

    def launch(resume, crash_after=0, check=True):
        env = dict(base_env)
        if crash_after:
            env["NGSDIST_TEST_CRASH_AFTER"] = str(crash_after)
        port = str(_free_port())
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", port, str(tmp_path),
                 "1", "1", "-", "1" if resume else "0", "0", "gp.bin"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True,
            )
            for pid in range(2)
        ]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            if check:
                assert p.returncode == 0, out
            else:
                assert p.returncode == 17, out  # the planted hard exit
        return outs

    # uninterrupted run: 4 matrices (3 bootstrap replicates)
    launch(resume=False)
    full = (tmp_path / "mh.dist").read_bytes()
    (tmp_path / "mh.dist").unlink()
    for p in tmp_path.glob("mh.dist.*"):
        p.unlink()

    # crash mid-replicate-1 (rep 0 = calls 1-3 + durable write; call 5 =
    # second round of rep 1), then resume
    launch(resume=False, crash_after=5, check=False)
    assert (tmp_path / "mh.dist").read_bytes() != full  # partial output
    # the crash left an in-flight replicate's round checkpoint — the
    # resume must go through the round-resume broadcast, not just the
    # durable-replicate skip
    assert list(tmp_path.glob("mh.dist*.rounds.npz")), \
        list(tmp_path.iterdir())
    launch(resume=True)
    assert (tmp_path / "mh.dist").read_bytes() == full


@pytest.mark.slow
def test_run_distributed_coded(tmp_path):
    """2-process --call_geno CODED paths — the resident from_reader
    uint8 code plane and lazy coded rounds — are byte-identical to the
    staged 2-process runs (f64: the lut expansion IS the staged
    post-call tensor, and chunking/reduction order match)."""
    rng = np.random.default_rng(21)
    gp = rng.dirichlet(np.ones(3), size=(57, 6))
    gp[rng.random((57, 6)) < 0.15] = 1 / 3
    gp[3, 0] = [0.4, 0.4, 0.2]  # argmax tie

    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_WORKER.format(repo=REPO))
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "NGSDIST_DEVICE_BUDGET",
                             "NGSDIST_HOST_BUDGET")}

    def run(tag, extra_env):
        wd = tmp_path / tag
        wd.mkdir()
        gp.tofile(str(wd / "gp.bin"))
        port = str(_free_port())
        env = dict(base_env)
        env["NGSDIST_TEST_CALL_GENO"] = "1"
        env["NGSDIST_CODED_UPLOAD"] = "1"
        env.update(extra_env)
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", port, str(wd),
                 "1", "1", "-", "0", "0", "gp.bin"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, text=True,
            )
            for pid in range(2)
        ]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-2000:]
        with open(wd / "mh.dist") as fh:
            return fh.read()

    staged = run("staged", {"NGSDIST_FUSED_READ": "0"})
    assert run("coded", {}) == staged

    lazy_env = {"NGSDIST_HOST_BUDGET": "1000",
                "NGSDIST_DEVICE_BUDGET": str(5 * 6 * 3 * 8)}
    lazy_staged = run("lazy_staged", {**lazy_env, "NGSDIST_FUSED_READ": "0"})
    assert run("lazy_coded", dict(lazy_env)) == lazy_staged


# ---- folded in from the former tests/test_distributed.py ----
# (suffstats-level 2-process psum equivalence; the tests above cover
# the full run_distributed pipeline)

_SUFFSTATS_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np

pid, nproc, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=nproc, process_id=pid)
sys.path.insert(0, {repo!r})
import jax.numpy as jnp
from ngsdist_jax.config import Params, default_score_matrix
from ngsdist_jax.parallel import mesh as pm
from ngsdist_jax.parallel import multihost as mh
from ngsdist_jax.parallel.mesh import _indep_sharded, shard_sites

mesh = pm.make_mesh()
pars = Params(in_geno=os.path.join(workdir, "gp.bin"), in_bin=True,
              in_probs=True, n_ind=6, n_sites=37, out="x", seed=1)
arr, s_pad = mh.load_global_probs(pars, mesh)
mask = np.zeros((s_pad,)); mask[:pars.n_sites] = 1.0
m = shard_sites(mask, mesh)
raw, cnt = _indep_sharded(arr, m, m, jnp.asarray(default_score_matrix()), True, mesh)
if pid == 0:
    np.save(os.path.join(workdir, "raw_mh.npy"), np.asarray(raw.addressable_data(0)))
print("OK", pid)
"""


@pytest.mark.slow
def test_two_process_psum_matches_single(tmp_path):
    rng = np.random.default_rng(7)
    gp = rng.dirichlet(np.ones(3), size=(37, 6))
    gp.tofile(str(tmp_path / "gp.bin"))

    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_SUFFSTATS_WORKER.format(repo=REPO))
    port = str(_free_port())

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    raw_mh = np.load(str(tmp_path / "raw_mh.npy"))

    import jax.numpy as jnp

    from ngsdist_jax.config import default_score_matrix
    from ngsdist_jax.core.distance import indep_suffstats

    raw1, _ = indep_suffstats(jnp.asarray(gp), jnp.asarray(default_score_matrix()), True)
    np.testing.assert_allclose(raw_mh, np.asarray(raw1), rtol=0, atol=1e-12)
