"""Intra-replicate round checkpoints for streamed long-genome runs.

A streamed replicate accumulates sufficient statistics over site
rounds; utils/checkpoint.save_rounds persists the accumulator after
each round, so an interruption mid-replicate loses at most one round
and the resumed run is byte-identical (the statistics are exact partial
sums of a deterministic computation)."""

import os

import numpy as np
import pytest

from ngsdist_jax.config import Params
from ngsdist_jax.core import bootstrap as bt
from ngsdist_jax.core import distance as dist
from ngsdist_jax.utils import checkpoint as ckpt


def _rand_probs(rng, S, N):
    P = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float64)
    P[rng.random((S, N)) < 0.15] = 1.0 / 3.0
    return P


def _pars(tmp_path, S, N, **kw):
    kw.setdefault("seed", 3)
    return Params(in_geno="x", n_ind=N, n_sites=S, in_probs=True,
                  out=str(tmp_path / "o.dist"), verbose=0, **kw)


def test_single_device_round_resume(tmp_path, monkeypatch):
    """Kill after 2 of many chunks, resume: identical output, and the
    completed chunks are NOT recomputed."""
    rng = np.random.default_rng(40)
    S, N = 96, 5
    P = _rand_probs(rng, S, N)
    pars = _pars(tmp_path, S, N, indep_geno=True, pairwise_del=True)
    # budget covers the working set (factor x the resident tensor) and
    # the planner reserves the prefetch fraction, so 16-site chunks
    # need WORKING_SET_FACTOR * DEN/NUM times the raw chunk bytes
    monkeypatch.setenv(
        "NGSDIST_DEVICE_BUDGET",
        str(dist._WORKING_SET_FACTOR * dist.PREFETCH_KEEP_DEN * 16 * N * 3 * 8
            // dist.PREFETCH_KEEP_NUM),
    )

    expected = list(dist.iter_replicates(pars, P, [], S))
    ckpt.clear(pars.out)

    calls = []
    orig = dist.indep_suffstats

    def spy(*a, **k):
        calls.append(1)
        if len(calls) == 3 and not spy.resumed:
            raise KeyboardInterrupt("simulated kill mid-replicate")
        return orig(*a, **k)

    spy.resumed = False
    monkeypatch.setattr(dist, "indep_suffstats", spy)

    with pytest.raises(KeyboardInterrupt):
        list(dist.iter_replicates(pars, P, [], S, round_ckpt=True))
    assert len(calls) == 3  # 2 completed rounds + the failing third

    # rounds sidecar holds the partial accumulator
    got = ckpt.load_rounds(pars.out, pars, 0, engine="jax")
    assert got is not None and got[0] == 2

    spy.resumed = True
    calls.clear()
    resumed = list(dist.iter_replicates(pars, P, [], S, round_ckpt=True))
    n_rounds_total = (S + 15) // 16
    assert len(calls) == n_rounds_total - 2, "completed rounds were recomputed"
    np.testing.assert_array_equal(resumed[0], expected[0])


def test_round_ckpt_ignored_on_mismatch(tmp_path, monkeypatch):
    """A stale rounds file from different parameters must be ignored."""
    rng = np.random.default_rng(41)
    S, N = 64, 4
    P = _rand_probs(rng, S, N)
    pars = _pars(tmp_path, S, N, indep_geno=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(16 * N * 3 * 8))
    clean = list(dist.iter_replicates(pars, P, [], S))

    other = _pars(tmp_path, S, N, indep_geno=True, seed=99)
    ckpt.save_rounds(pars.out, other, 0, 2,
                     {"raw": np.full((N, N), 1e9)})
    out = list(dist.iter_replicates(pars, P, [], S, round_ckpt=True))
    np.testing.assert_array_equal(out[0], clean[0])


def test_round_ckpt_single_file_atomic(tmp_path):
    """The rounds checkpoint commits in ONE os.replace (meta inside the
    npz): a torn/partial file — the only state a kill can leave besides
    a complete checkpoint — is rejected as a whole instead of meta
    running one round ahead of its arrays (advisor r2, medium)."""
    pars = _pars(tmp_path, 64, 4, indep_geno=True)
    ckpt.save_rounds(pars.out, pars, 0, 3, {"raw": np.ones((4, 4))},
                     engine="jax")
    path = ckpt.rounds_path(pars.out)
    assert not os.path.exists(path + ".meta")  # no second file to tear
    got = ckpt.load_rounds(pars.out, pars, 0, engine="jax")
    assert got is not None and got[0] == 3

    # simulate a kill mid-write: truncate the committed file
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 2])
    assert ckpt.load_rounds(pars.out, pars, 0, engine="jax") is None


def _pos_alleles(S, rng):
    from ngsdist_jax.core.submodels import encode_alleles

    bases = np.array(["A", "C", "G", "T"])
    rows = []
    for s in range(S):
        a, b = rng.choice(4, size=2, replace=False)
        rows.append(("chr1", str(s + 1), bases[a], bases[b]))
    return encode_alleles(rows)


def test_extended_single_device_round_resume(tmp_path, monkeypatch):
    """Models 3-6 stream chunk rounds with checkpoints too: kill after 2
    rounds, resume, identical output (VERDICT round-2 follow-up — the
    extended path was replicate-level only)."""
    rng = np.random.default_rng(43)
    S, N = 96, 5
    P = _rand_probs(rng, S, N)
    alleles = _pos_alleles(S, rng)
    pars = _pars(tmp_path, S, N, indep_geno=True, pairwise_del=True,
                 evol_model=6)
    # the planner reserves the prefetch fraction of the chunk budget
    # (see test_single_device_round_resume)
    monkeypatch.setenv(
        "NGSDIST_DEVICE_BUDGET",
        str(dist._WORKING_SET_FACTOR * dist.PREFETCH_KEEP_DEN * 16 * N * 3 * 8
            // dist.PREFETCH_KEEP_NUM),
    )

    expected = list(dist.iter_replicates(pars, P, [], S, alleles=alleles))
    ckpt.clear(pars.out)

    calls = []
    orig = dist.indep_suffstats

    def spy(*a, **k):
        calls.append(1)
        # 3 class calls per chunk round; die in round 3
        if len(calls) == 7 and not spy.resumed:
            raise KeyboardInterrupt("simulated kill mid-replicate")
        return orig(*a, **k)

    spy.resumed = False
    monkeypatch.setattr(dist, "indep_suffstats", spy)

    with pytest.raises(KeyboardInterrupt):
        list(dist.iter_replicates(pars, P, [], S, alleles=alleles,
                                  round_ckpt=True))
    got = ckpt.load_rounds(pars.out, pars, 0, engine="jax")
    assert got is not None and got[0] == 2
    assert "raw_ag" in got[1] and "cnt_tv" in got[1] and "pi" not in got[1]

    spy.resumed = True
    calls.clear()
    resumed = list(dist.iter_replicates(pars, P, [], S, alleles=alleles,
                                        round_ckpt=True))
    n_rounds_total = (S + 15) // 16
    assert len(calls) == 3 * (n_rounds_total - 2), "rounds were recomputed"
    np.testing.assert_array_equal(resumed[0], expected[0])


def test_extended_mesh_round_resume(tmp_path, monkeypatch):
    """The sharded extended path (model 6, needs pair-pi): kill in round
    3, resume from the 7-accumulator checkpoint, identical output."""
    from ngsdist_jax.parallel import mesh as pm

    mesh = pm.make_mesh(n_devices=4)
    rng = np.random.default_rng(44)
    S, N = 90, 4
    P = _rand_probs(rng, S, N)
    alleles = _pos_alleles(S, rng)
    pars = _pars(tmp_path, S, N, indep_geno=True, pairwise_del=True,
                 evol_model=6, n_boot_rep=1, boot_block_size=3)
    n_trunc, maps = bt.site_maps(pars.seed, 1, S, 3)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(6 * N * 3 * 8))

    expected = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                         alleles=alleles, mesh=mesh))
    ckpt.clear(pars.out)

    calls = {"n": 0, "armed": True}
    orig = pm.sharded_suffstats

    def spy(*a, **k):
        calls["n"] += 1
        # 3 class calls per round; die in round 3 of replicate 1
        if calls["armed"] and calls["n"] == 7:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(pm, "sharded_suffstats", spy)
    with pytest.raises(KeyboardInterrupt):
        list(dist.iter_replicates(pars, P, maps, n_trunc, alleles=alleles,
                                  mesh=mesh, round_ckpt=True, start_rep=1))
    got = ckpt.load_rounds(pars.out, pars, 1, engine="jax")
    assert got is not None and got[0] == 2
    assert "pi" in got[1]

    calls["armed"] = False
    resumed = list(dist.iter_replicates(pars, P, maps, n_trunc,
                                        alleles=alleles, mesh=mesh,
                                        round_ckpt=True, start_rep=1))
    np.testing.assert_array_equal(resumed[0], expected[1])


def test_sharded_streaming_round_resume(tmp_path, monkeypatch):
    """The mesh streaming path: same kill-and-resume contract, incl. a
    bootstrap replicate (per-rep keyed checkpoints)."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    mesh = pm.make_mesh(n_devices=4)
    rng = np.random.default_rng(42)
    S, N = 90, 4
    P = _rand_probs(rng, S, N)
    pars = _pars(tmp_path, S, N, indep_geno=False, pairwise_del=True,
                 n_boot_rep=1, boot_block_size=3)
    n_trunc, maps = bt.site_maps(pars.seed, 1, S, 3)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(6 * N * 3 * 8))

    expected = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh))
    ckpt.clear(pars.out)

    # interrupt during replicate 1 (rep index 1), third round
    calls = {"n": 0, "armed": True}
    orig = pm.sharded_suffstats

    def spy(*a, **k):
        calls["n"] += 1
        if calls["armed"] and calls["n"] == 3:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(pm, "sharded_suffstats", spy)
    gen = dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh,
                               round_ckpt=True, start_rep=1)
    with pytest.raises(KeyboardInterrupt):
        list(gen)
    got = ckpt.load_rounds(pars.out, pars, 1, engine="jax")
    assert got is not None and got[0] == 2

    calls["armed"] = False
    calls["n"] = 0
    resumed = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh,
                                        round_ckpt=True, start_rep=1))
    np.testing.assert_array_equal(resumed[0], expected[1])


def test_lazy_stream_round_resume(tmp_path, monkeypatch):
    """LAZY disk-streamed rounds + round checkpoints: kill mid-replicate,
    resume — the skipped rounds are neither recomputed NOR re-read from
    disk, and the output is byte-identical."""
    from ngsdist_jax.parallel import mesh as pm
    from ngsdist_jax.parallel import multihost as mh

    mesh = pm.make_mesh(n_devices=4)
    rng = np.random.default_rng(45)
    S, N = 88, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = tmp_path / "gp.bin"
    gp.tofile(path)
    pars = _pars(tmp_path, S, N, indep_geno=True, pairwise_del=True)
    pars = Params(in_geno=str(path), in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, out=str(tmp_path / "o.dist"), seed=3, verbose=0,
                  indep_geno=True, pairwise_del=True)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(8 * N * 3 * 8))
    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1200")

    def make_stream():
        st = mh.SiteStream.from_reader(pars, mesh, np.float64)
        assert st.lazy and st.n_rounds > 2
        return st

    expected = list(dist.iter_replicates(pars, make_stream(), [], S,
                                         mesh=mesh))
    ckpt.clear(pars.out)

    calls = {"n": 0, "armed": True}
    orig = pm.sharded_suffstats

    def spy(*a, **k):
        calls["n"] += 1
        if calls["armed"] and calls["n"] == 3:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(pm, "sharded_suffstats", spy)
    with pytest.raises(KeyboardInterrupt):
        list(dist.iter_replicates(pars, make_stream(), [], S, mesh=mesh,
                                  round_ckpt=True))
    got = ckpt.load_rounds(pars.out, pars, 0, engine="jax")
    assert got is not None and got[0] == 2

    # resume must not re-read the completed rounds from disk
    calls["armed"] = False
    calls["n"] = 0
    stream = make_stream()
    reads = {"n": 0}
    orig_rd = type(stream).round_data

    def counting_round_data(self, r):
        reads["n"] += 1
        return orig_rd(self, r)

    monkeypatch.setattr(type(stream), "round_data", counting_round_data)
    resumed = list(dist.iter_replicates(pars, stream, [], S, mesh=mesh,
                                        round_ckpt=True))
    assert reads["n"] == stream.n_rounds - 2, "completed rounds re-read"
    np.testing.assert_array_equal(resumed[0], expected[0])


def test_broadcast_f64_exact_under_x32():
    """Multi-host round-ckpt resume broadcasts host-f64 accumulators
    (sums of f32 rounds, generally not f32-representable).  Under
    x64-off — every f32 device run — a plain broadcast_one_to_all
    device_puts and silently truncates them to f32; the byte-view
    broadcast must stay bit-exact."""
    import jax

    # an f64 value that is NOT f32-representable (f32 sum + tiny tail)
    a = np.float64(16777216.0) + np.linspace(0.1, 0.9, 7)
    assert not np.array_equal(a.astype(np.float32).astype(np.float64), a)
    jax.config.update("jax_enable_x64", False)
    try:
        # the hazard: multi-process broadcast_one_to_all routes arrays
        # through a jit whose x64-off canonicalization truncates f64 to
        # f32 (single-process short-circuits to np.asarray, so
        # demonstrate the mechanism at the jit boundary it uses)
        naive = np.asarray(jax.jit(lambda x: x)(a), np.float64)
        assert not np.array_equal(naive, a)
        # a uint8 byte view survives the same boundary bit-exactly
        via_jit = np.asarray(
            jax.jit(lambda x: x)(np.ascontiguousarray(a).view(np.uint8)))
        np.testing.assert_array_equal(via_jit.view(np.float64), a)
        # and the resume helper (passthrough single-process) is exact
        got = dist._broadcast_f64_exact(a)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, a)
    finally:
        jax.config.update("jax_enable_x64", True)
