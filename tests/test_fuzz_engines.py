"""Randomized-config cross-engine fuzz: jax engine vs bit-exact oracle.

Draws random flag combinations (indep/EM, pairwise deletion, calling
thresholds, avg_nuc_dist, models 0-2, tot_sites, bootstrap shapes) and
random GL/GP/genotype tensors, runs both engines end-to-end through the
runner, and requires float64 agreement to 1e-10 on every matrix of every
replicate.  Complements the fixed golden suite by sweeping corners the
goldens don't enumerate.
"""

import gzip
import os

import numpy as np
import pytest

from ngsdist_jax import runner
from ngsdist_jax.config import Params


def _write_inputs(tmp_path, rng, S, N, kind):
    if kind == "bin":  # raw binary GP (the lazy-stream-capable format)
        path = str(tmp_path / "in.bin")
        gp = rng.dirichlet(np.ones(3) * rng.uniform(0.5, 8), size=(S, N))
        gp.tofile(path)
        return path, dict(in_probs=True, in_bin=True)
    path = str(tmp_path / f"in_{kind}.geno.gz")
    # empty lines consume the site as missing (read_data.cpp control
    # flow) — the only source of all-zero triples downstream, so draw
    # them (upload23's PAD23 sentinel path, exact-engine parity)
    empty = (rng.random(S) < 0.1) if rng.random() < 0.3 else np.zeros(S, bool)
    if kind == "gt":
        g = rng.integers(-1, 3, size=(S, N))
        with gzip.open(path, "wt") as fh:
            for s in range(S):
                fh.write("" if empty[s] else
                         "\t".join(str(int(x)) for x in g[s]))
                fh.write("\n")
        return path, dict()
    gp = rng.dirichlet(np.ones(3) * rng.uniform(0.5, 8), size=(S, N))
    if rng.random() < 0.3:
        gp[rng.random((S, N)) < 0.2] = 1 / 3  # missing
    with gzip.open(path, "wt") as fh:
        for s in range(S):
            fh.write("" if empty[s] else
                     "\t".join(f"{x:.8f}" for x in gp[s].reshape(-1)))
            fh.write("\n")
    return path, dict(in_probs=True)


@pytest.mark.parametrize("trial", range(24))
def test_random_config_engines_agree(tmp_path, trial):
    rng = np.random.default_rng(1000 + trial)
    S = int(rng.integers(20, 150))
    N = int(rng.integers(3, 9))
    kind = rng.choice(["gt", "gp"])
    path, extra = _write_inputs(tmp_path, rng, S, N, kind)

    kw = dict(extra)
    if kind == "gp":
        if rng.random() < 0.4:
            kw["indep_geno"] = True
        if rng.random() < 0.3:
            kw["call_geno"] = True
            if rng.random() < 0.5:
                kw["N_thresh"] = float(rng.uniform(0, 0.4))
                kw["call_thresh"] = float(rng.uniform(0.5, 0.95))
    pairwise_del = bool(rng.random() < 0.5)
    kw["pairwise_del"] = pairwise_del
    if not pairwise_del and rng.random() < 0.3:
        kw["tot_sites"] = int(S + rng.integers(0, 50))
    kw["avg_nuc_dist"] = bool(rng.random() < 0.3)
    kw["evol_model"] = int(rng.integers(0, 3))
    if rng.random() < 0.6:
        kw["n_boot_rep"] = int(rng.integers(1, 4))
        kw["boot_block_size"] = int(rng.integers(1, max(2, S // 4)))

    base = dict(in_geno=path, n_ind=N, n_sites=S, seed=int(rng.integers(1, 10000)),
                verbose=0, **kw)
    a = runner.run(Params(out=str(tmp_path / "a.dist"), **base), engine="exact")
    b = runner.run(Params(out=str(tmp_path / "b.dist"), **base), engine="jax")
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        np.testing.assert_allclose(mb, ma, rtol=0, atol=1e-10, err_msg=str(kw))


@pytest.mark.parametrize("trial", range(16))
def test_random_config_sharded_streamed_agree(tmp_path, trial, monkeypatch):
    """Same cross-engine contract under randomized SCALE-OUT shapes:
    random 1-D/2-D meshes and random (sometimes tiny) device budgets, so
    the sharded, pairs-split and SiteStream-round paths all fuzz against
    the bit-exact oracle."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    rng = np.random.default_rng(5000 + trial)
    S = int(rng.integers(30, 120))
    N = int(rng.integers(3, 8))
    kind = rng.choice(["gt", "gp", "bin"])
    path, extra = _write_inputs(tmp_path, rng, S, N, kind)

    kw = dict(extra)
    if kind in ("gp", "bin") and rng.random() < 0.4:
        kw["indep_geno"] = True
    if kind in ("gp", "bin") and rng.random() < 0.3:
        kw["call_geno"] = True  # forces indep; thresholds sometimes set
        if rng.random() < 0.5:
            kw["N_thresh"] = float(rng.uniform(0, 0.4))
            kw["call_thresh"] = float(rng.uniform(0.5, 0.95))
    kw["pairwise_del"] = bool(rng.random() < 0.5)
    kw["evol_model"] = int(rng.integers(0, 3))
    if rng.random() < 0.6:
        kw["n_boot_rep"] = int(rng.integers(1, 3))
        kw["boot_block_size"] = int(rng.integers(1, max(2, S // 5)))

    n_dev = int(rng.choice([2, 4, 8]))
    pairs = int(rng.choice([1, 1, 2]))
    if n_dev % pairs:
        pairs = 1
    mesh = pm.make_mesh(n_devices=n_dev, pairs=pairs)
    if rng.random() < 0.5:  # force SiteStream rounds
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(8 * N * 3 * 8))
    else:
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    if pairs == 1 and rng.random() < 0.5:
        # lazy disk-streamed rounds: binary inputs seek in place, text
        # (gt/gp gz) inputs spill a parsed cache first — both fuzz here
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1500")
        monkeypatch.setenv("NGSDIST_SPILL_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)

    base = dict(in_geno=path, n_ind=N, n_sites=S, seed=int(rng.integers(1, 10000)),
                verbose=0, **kw)
    a = runner.run(Params(out=str(tmp_path / "a.dist"), **base), engine="exact")
    b = runner.run(Params(out=str(tmp_path / "b.dist"), **base), engine="jax",
                   mesh=mesh)
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        np.testing.assert_allclose(
            mb, ma, rtol=0, atol=1e-10,
            err_msg=f"{kw} mesh=({n_dev},{pairs})",
        )


@pytest.mark.parametrize("trial", range(10))
def test_random_config_upload23_agree(tmp_path, trial, monkeypatch):
    """f32 (x64-off) fuzz of the 2-of-3-component upload lane: random
    configs/inputs (incl. empty-line text sites, the all-zero-triple
    source), random meshes and streaming budgets, jax engine with
    NGSDIST_UPLOAD23 forced off vs on.  Distances must agree to the
    reconstruction floor (~1e-7 per site; EPSILON classification and
    therefore valid-site counts are invariant)."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    rng = np.random.default_rng(7000 + trial)
    S = int(rng.integers(30, 120))
    N = int(rng.integers(3, 8))
    kind = rng.choice(["gt", "gp", "bin"])
    path, extra = _write_inputs(tmp_path, rng, S, N, kind)

    kw = dict(extra)
    if kind in ("gp", "bin") and rng.random() < 0.5:
        kw["indep_geno"] = True
    kw["pairwise_del"] = bool(rng.random() < 0.5)
    kw["evol_model"] = int(rng.integers(0, 3))
    if rng.random() < 0.5:
        kw["n_boot_rep"] = int(rng.integers(1, 3))
        kw["boot_block_size"] = int(rng.integers(1, max(2, S // 5)))

    mesh = (pm.make_mesh(n_devices=int(rng.choice([2, 4])))
            if rng.random() < 0.5 else None)
    if rng.random() < 0.5:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(8 * N * 3 * 8))
    if mesh is not None and rng.random() < 0.5:
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1500")
        monkeypatch.setenv("NGSDIST_SPILL_DIR", str(tmp_path))

    base = dict(in_geno=path, n_ind=N, n_sites=S,
                seed=int(rng.integers(1, 10000)), verbose=0, **kw)
    jax.config.update("jax_enable_x64", False)
    try:
        out = {}
        for env in ("0", "1"):
            monkeypatch.setenv("NGSDIST_UPLOAD23", env)
            out[env] = runner.run(
                Params(out=str(tmp_path / f"u{env}.dist"), **base),
                engine="jax", mesh=mesh)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert len(out["0"]) == len(out["1"])
    # EM-path draws (no indep): a ~1e-7 p2 reconstruction difference
    # can flip an EM exit test sitting within ulps of the tole=1e-3
    # threshold, moving that pair by the ~1e-4 convergence-plateau
    # class (fresh-seed soak trial 721); indep draws stay at the
    # reconstruction floor.
    em_path = not kw.get("indep_geno")
    atol = 5e-6 if not em_path else (
        2e-3 if kw["evol_model"] == 2 else 4e-4)  # plateau x JC69 pole
    for ma, mb in zip(out["0"], out["1"]):
        np.testing.assert_allclose(mb, ma, rtol=0, atol=atol,
                                   err_msg=f"{kw} mesh={mesh is not None}")


@pytest.mark.parametrize("trial", range(12))
def test_random_routing_gates_agree(tmp_path, trial, monkeypatch):
    """Fuzz of the ROUTING gates themselves (VERDICT r04 item 7): raw
    binary inputs drawn with host/device budgets randomly ABOVE and
    BELOW the tensor footprint, fused reads on/off, the uint16 lane
    on/off, coded (--call_geno) and packed routes, resident / chunked /
    lazy / mesh streams — every draw must produce the same matrices as
    the staged resident f32 baseline (atol covers the documented uint16
    quantization class; coded and f32 routes sit at ~1e-7).  This is
    the randomized coverage of runner._fused_packed_wanted /
    _fused_coded_wanted / _lazy_stream_wanted and
    SiteStream.coded_call_eligible at shapes on both sides of each
    threshold."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    rng = np.random.default_rng(9000 + trial)
    S = int(rng.integers(40, 200))
    N = int(rng.integers(3, 9))
    path, extra = _write_inputs(tmp_path, rng, S, N, "bin")

    kw = dict(extra)
    if rng.random() < 0.5:
        kw["indep_geno"] = True
    if rng.random() < 0.4:
        kw["call_geno"] = True  # default thresholds -> coded-eligible
    kw["pairwise_del"] = bool(rng.random() < 0.5)
    kw["evol_model"] = int(rng.integers(0, 3))
    if rng.random() < 0.4:
        kw["n_boot_rep"] = int(rng.integers(1, 3))
        kw["boot_block_size"] = int(rng.integers(1, max(2, S // 5)))
    base = dict(in_geno=path, n_ind=N, n_sites=S,
                seed=int(rng.integers(1, 10000)), verbose=0, **kw)

    tensor_bytes = S * N * 3 * 8
    jax.config.update("jax_enable_x64", False)
    try:
        baseline_env = {"NGSDIST_FUSED_READ": "0", "NGSDIST_UPLOAD16": "0",
                        "NGSDIST_CODED_UPLOAD": "0"}
        for k, v in baseline_env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
        want = runner.run(Params(out=str(tmp_path / "base.dist"), **base),
                          engine="jax")

        # the randomized routing draw
        monkeypatch.setenv("NGSDIST_FUSED_READ",
                           str(rng.choice(["auto", "0"])))
        monkeypatch.setenv("NGSDIST_UPLOAD16", str(rng.choice(["0", "1"])))
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD",
                           str(rng.choice(["auto", "0", "1"])))
        if rng.random() < 0.6:  # host budget below/above the footprint
            lo = rng.random() < 0.5
            monkeypatch.setenv("NGSDIST_HOST_BUDGET",
                               str(tensor_bytes // 4 if lo
                                   else tensor_bytes * 16))
            monkeypatch.setenv("NGSDIST_SPILL_DIR", str(tmp_path))
        if rng.random() < 0.6:  # device budget below/above
            lo = rng.random() < 0.5
            monkeypatch.setenv("NGSDIST_DEVICE_BUDGET",
                               str(max(1024, tensor_bytes // 6) if lo
                                   else tensor_bytes * 16))
        mesh = (pm.make_mesh(n_devices=int(rng.choice([2, 4, 8])))
                if rng.random() < 0.4 else None)
        got = runner.run(Params(out=str(tmp_path / "got.dist"), **base),
                         engine="jax", mesh=mesh)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert len(want) == len(got)
    # uint16 quantization noise in raw/cnt is ~1.5e-5/sqrt(S) per pair;
    # the model-2 (K2P) log transform multiplies it by 1/(1-2P-Q)-style
    # pole derivatives, so its bound is looser at these tiny fuzz S.
    # EM-path draws (no indep, no call_geno) carry the f32 EM
    # convergence-plateau class on top: chunk/round grouping moves
    # where each lane stops on the tole=1e-3 loglik plateau (~1e-4;
    # see test_jax_engine.test_em_overlap_stream_matches_resident).
    em_path = not kw.get("indep_geno") and not kw.get("call_geno")
    atol = (2e-3 if em_path and kw["evol_model"] == 2 else
            4e-4 if em_path else
            3e-4 if kw["evol_model"] == 2 else 5e-5)
    for ma, mb in zip(want, got):
        np.testing.assert_allclose(
            mb, ma, rtol=0, atol=atol,
            err_msg=f"{kw} mesh={mesh is not None} env="
                    f"{ {k: os.environ.get(k) for k in ('NGSDIST_FUSED_READ', 'NGSDIST_UPLOAD16', 'NGSDIST_CODED_UPLOAD', 'NGSDIST_HOST_BUDGET', 'NGSDIST_DEVICE_BUDGET') } }")


@pytest.mark.parametrize("budget_sites,bs", [(3, 1), (5, 1), (9, 2), (5, 4)])
def test_streamed_partials_ragged_chunks(tmp_path, monkeypatch,
                                         budget_sites, bs):
    """Streamed indep-bootstrap block partials with round chunks that
    do NOT divide the per-device shard (round-5 routing fuzz trial
    507): the device-major concatenated layout leaves per-round pad
    rows inside each device's range, and the resummation weights must
    be permuted by the true row->block map (distance._stream_block_rows)
    — positional vectors silently dropped trailing devices' blocks
    (5e-2 errors).  Exact-oracle parity across ragged chunk/block
    geometries."""
    import jax

    from ngsdist_jax.parallel import mesh as pm

    rng = np.random.default_rng(77)
    S, N = 54, 6
    path = str(tmp_path / "g.bin")
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    gp.tofile(path)
    base = dict(in_geno=path, in_probs=True, in_bin=True, n_ind=N,
                n_sites=S, seed=4242, verbose=0, indep_geno=True,
                pairwise_del=False, evol_model=1, n_boot_rep=3,
                boot_block_size=bs)
    a = runner.run(Params(out=str(tmp_path / "a.dist"), **base),
                   engine="exact")
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET",
                       str(budget_sites * N * 3 * 8 * 2))
    mesh = pm.make_mesh(n_devices=4)
    b = runner.run(Params(out=str(tmp_path / "b.dist"), **base),
                   engine="jax", mesh=mesh)
    assert len(a) == len(b) == 4
    for ma, mb in zip(a, b):
        np.testing.assert_allclose(mb, ma, rtol=0, atol=1e-10)
