"""Device bring-up rules: compile-cache location, device-memory budget,
per-process card binding and the --platform pin."""

import os
import subprocess
import sys

import jax
import pytest

from ngsdist_jax.config import NgsDistError
from ngsdist_jax.utils import compile_cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ #
# compile cache                                                        #
# ------------------------------------------------------------------ #


def test_cache_env_dir_is_left_to_jax(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache.cache_dir() is None


def test_cache_default_is_fixed_gitignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("NGSDIST_COMPILE_CACHE", raising=False)
    d = compile_cache.cache_dir()
    assert d == compile_cache.CACHE_DIR == compile_cache.cache_dir()
    assert os.path.dirname(d) == REPO_ROOT
    rel = os.path.relpath(d, REPO_ROOT)
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert rel + "/" in f.read().split()
    # never derived from a temp name, a pid or the time
    assert str(os.getpid()) not in d
    assert not d.startswith(os.environ.get("TMPDIR", "/tmp"))


def test_cache_default_can_be_turned_off(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("NGSDIST_COMPILE_CACHE", "0")
    assert compile_cache.cache_dir() is None


@pytest.mark.parametrize("env_dir,backend,want", [
    (None, "gpu", "default"),   # device backend, no env: the fixed dir
    ("/from/env", "gpu", None),  # env names one: nothing set in code
    (None, "cpu", None),        # CPU backend: no cache
])
def test_cache_enable_sets_only_what_it_should(monkeypatch, tmp_path,
                                               env_dir, backend, want):
    updates = {}
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.setattr(compile_cache, "CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.delenv("NGSDIST_COMPILE_CACHE", raising=False)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    compile_cache.enable()
    if want is None:
        assert updates == {}
    else:
        assert updates["jax_compilation_cache_dir"] == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")


# ------------------------------------------------------------------ #
# device-memory budget                                                 #
# ------------------------------------------------------------------ #


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want_total", [
    ({"bytes_limit": 64 << 30, "bytes_in_use": 0}, (64 << 30) * 3 // 4),
    ({"bytes_limit": 12 << 30}, (12 << 30) * 3 // 4),
    (None, None),  # the CPU backend reports no limit
])
def test_device_budget_from_memory_stats(monkeypatch, stats, want_total):
    from ngsdist_jax.core import distance as dist

    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])
    if want_total is None:
        want_total = dist.HOST_DEVICE_BUDGET_BYTES
    assert dist._device_budget_bytes() == \
        want_total // dist._WORKING_SET_FACTOR


def test_device_budget_env_override(monkeypatch):
    from ngsdist_jax.core import distance as dist

    monkeypatch.setattr(jax, "local_devices", lambda: [
        _FakeDevice({"bytes_limit": 64 << 30})])
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(3000))
    assert dist._device_budget_bytes() == 1000


# ------------------------------------------------------------------ #
# multi-process card binding                                           #
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("process_id", [0, 3])
def test_bring_up_binds_each_process_to_its_card(monkeypatch, process_id):
    from ngsdist_jax.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/nowhere")
    multihost.bring_up("localhost:1234", 4, process_id, [process_id])
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": process_id,
                    "local_device_ids": [process_id]}
    # each process autotunes its own programs (set before the backend)
    assert os.environ["XLA_FLAGS"] == (
        "--xla_dump_to=/nowhere " + multihost.SHARD_AUTOTUNING_OFF)
    multihost.bring_up("localhost:1234", 4, process_id, [process_id])
    assert os.environ["XLA_FLAGS"].count("shard_autotuning") == 1


def test_bring_up_without_coordinator_is_a_no_op(monkeypatch):
    from ngsdist_jax.parallel import multihost

    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: pytest.fail("initialized"))
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    multihost.bring_up(None, None, None, [0])
    assert "XLA_FLAGS" not in os.environ


def test_cli_passes_local_device_ids(monkeypatch):
    from ngsdist_jax import cli
    from ngsdist_jax.parallel import multihost

    from ngsdist_jax.utils import signals

    seen = {}
    monkeypatch.setattr(signals, "arm", lambda: None)
    monkeypatch.setattr(multihost, "run_distributed",
                        lambda pars, **kw: seen.update(kw))
    rc = cli.main(["--geno", "x", "--n_ind", "2", "--n_sites", "3",
                   "--out", "o", "--verbose", "0",
                   "--coordinator", "localhost:1234", "--num_processes",
                   "4", "--process_id", "2", "--local_device_ids", "2"])
    assert rc == 0
    assert seen["local_device_ids"] == [2]
    assert seen["process_id"] == 2 and seen["num_processes"] == 4


def test_parse_device_ids():
    from ngsdist_jax.cli import parse_device_ids

    assert parse_device_ids(None) is None
    assert parse_device_ids("") is None
    assert parse_device_ids("1") == [1]
    assert parse_device_ids("0,2") == [0, 2]
    with pytest.raises(NgsDistError):
        parse_device_ids("a,b")


# ------------------------------------------------------------------ #
# --platform                                                           #
# ------------------------------------------------------------------ #


def test_platform_gpu_without_gpu_fails(tmp_path):
    """--platform gpu on a machine without a GPU exits 255 with an
    error; it never falls back to the CPU."""
    from tests.conftest import DATA_DIR

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = tmp_path / "o.dist"
    r = subprocess.run(
        [sys.executable, "-m", "ngsdist_jax", "--geno",
         os.path.join(DATA_DIR, "gp.bin"), "--probs", "--n_ind", "20",
         "--n_sites", "1200", "--out", str(out), "--platform", "gpu",
         "--engine", "jax"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 255, r.stderr[-2000:]
    assert "--platform gpu" in r.stderr
    assert not out.exists() or out.stat().st_size == 0


def test_platform_rejects_unknown_name():
    from ngsdist_jax.cli import pin_platform

    with pytest.raises(NgsDistError, match="cpu or gpu"):
        pin_platform("quantum")
