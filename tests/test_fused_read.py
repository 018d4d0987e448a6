"""Fused one-pass packed reader (native nd_read_geno_pack23).

The staged binary pipeline — read_geno (f64) -> preprocess exp ->
pack23 (f32 cast) — makes three full passes over the tensor; the fused
reader produces the upload-ready f32 [S, N, 2] slab in ONE native pass.
Contract pinned here:

  (a) bit-equality with the staged pipeline (same libm calls in the
      same order), full reads, ranged reads, and log-scale inputs;
  (b) the reference reader's error surface (premature EOF, trailing
      content, NaN precedence — read_data.cpp:29-47,106-109);
  (c) graceful None on non-raw inputs (gzip magic) so callers fall
      back to the staged path;
  (d) the ENGINE path: runner.run over a PackedBinInput produces the
      same matrices as the staged f32 run, resident and chunked.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from ngsdist_jax.config import NgsDistError, Params
from ngsdist_jax.core.preprocess import preprocess
from ngsdist_jax.io import readers
from ngsdist_jax.utils.hostmem import pack23


def _write_gp(tmp_path, S, N, seed=3, name="gp.bin"):
    rng = np.random.default_rng(seed)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    g[5 % S, 3 % N] = [1, 0, 0]   # one-hot: exp underflow in normalize
    g[(S - 1), N - 1] = [0, 0, 1]
    path = os.path.join(tmp_path, name)
    g.astype(np.float64).tofile(path)
    return path, g


def _staged(path, in_logscale, N, S):
    geno_log = readers.read_geno(path, True, True, in_logscale, N, S)
    return pack23(preprocess(geno_log, False, 0.0, 0.0), np.float32,
                  may_zero=False)


def test_bit_equal_full_range_logscale(tmp_path):
    S, N = 301, 17
    path, g = _write_gp(str(tmp_path), S, N)
    fused = readers.read_geno_pack23(path, False, N, S)
    assert fused is not None and fused.dtype == np.float32
    np.testing.assert_array_equal(_staged(path, False, N, S), fused)

    ranged = readers.read_geno_pack23(path, False, N, S,
                                      site_range=(50, 200))
    np.testing.assert_array_equal(fused[50:200], ranged)

    logp = os.path.join(str(tmp_path), "gl.bin")
    np.log(np.maximum(g, 1e-300)).tofile(logp)
    fused_l = readers.read_geno_pack23(logp, True, N, S)
    np.testing.assert_array_equal(_staged(logp, True, N, S), fused_l)


def test_error_surface(tmp_path):
    S, N = 64, 5
    path, g = _write_gp(str(tmp_path), S, N)
    with open(path, "rb") as fh:
        buf = fh.read()

    trunc = os.path.join(str(tmp_path), "trunc.bin")
    with open(trunc, "wb") as fh:
        fh.write(buf[:-40])
    with pytest.raises(NgsDistError, match="premature EOF"):
        readers.read_geno_pack23(trunc, False, N, S)

    over = os.path.join(str(tmp_path), "over.bin")
    with open(over, "wb") as fh:
        fh.write(buf + b"\0" * 8)
    with pytest.raises(NgsDistError, match="not at EOF"):
        readers.read_geno_pack23(over, False, N, S)
    # a ranged read that does NOT run to n_sites ignores trailing bytes
    assert readers.read_geno_pack23(over, False, N, S,
                                    site_range=(0, S - 1)) is not None

    # NaN outranks premature EOF (complete triples are normalized first)
    gn = g.copy()
    gn[10, 2] = np.nan
    nanp = os.path.join(str(tmp_path), "nan.bin")
    gn.tofile(nanp)
    with open(nanp, "rb") as fh:
        nbuf = fh.read()
    with open(nanp, "wb") as fh:
        fh.write(nbuf[:-40])
    with pytest.raises(NgsDistError, match="NaN found"):
        readers.read_geno_pack23(nanp, False, N, S)


def test_gzip_falls_back_to_none(tmp_path):
    import gzip
    import shutil

    S, N = 32, 4
    path, _ = _write_gp(str(tmp_path), S, N)
    gz = os.path.join(str(tmp_path), "gp.gz.bin")  # gz magic, raw name
    with open(path, "rb") as s, gzip.open(gz, "wb") as d:
        shutil.copyfileobj(s, d)
    assert readers.read_geno_pack23(gz, False, N, S) is None


@pytest.fixture
def f32_engine(monkeypatch):
    """Force the f32 2-component engine path under the x64 test config
    (the fused fast path is f32-only; production device runs are x64-off)."""
    from ngsdist_jax.core import distance as dist

    monkeypatch.setenv("NGSDIST_UPLOAD23", "1")
    monkeypatch.setattr(dist, "default_dtype", lambda: jnp.float32)
    return dist


def _run_engine(pars, P):
    from ngsdist_jax.core import bootstrap as bt
    from ngsdist_jax.core import distance as dist

    n_trunc, maps = bt.site_maps(pars.seed, pars.n_boot_rep, pars.n_sites,
                                 pars.boot_block_size)
    return list(dist.iter_replicates(pars, P, maps, n_trunc))


@pytest.mark.parametrize("budget", [None, 40000])
def test_engine_matches_staged(tmp_path, monkeypatch, f32_engine, budget):
    """runner fast path vs staged f32 path: identical matrices on the
    resident (pipelined concat upload) and chunked (per-chunk fused
    disk reads) streams, including bootstrap replicates."""
    if budget is not None:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    S, N = 600, 8
    path, _ = _write_gp(str(tmp_path), S, N, seed=11)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, indep_geno=True, pairwise_del=True,
                  evol_model=1, seed=5, n_boot_rep=2, boot_block_size=10,
                  verbose=0, out=os.path.join(str(tmp_path), "o.dist"))
    pars.validate()
    pars.finalize()

    staged_P = preprocess(
        readers.read_geno(path, True, True, False, N, S), False, 0.0, 0.0)
    want = _run_engine(pars, staged_P)
    got = _run_engine(pars, readers.PackedBinInput(pars))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_runner_gating(tmp_path, monkeypatch, f32_engine):
    """_fused_packed_wanted: on for raw-binary f32 jax runs, off for
    text/gz/stdin, exact engine, calling, extended models, v>=8, env."""
    from ngsdist_jax import runner

    S, N = 16, 3
    path, _ = _write_gp(str(tmp_path), S, N, seed=2)
    base = dict(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                n_sites=S, indep_geno=True, verbose=0)
    assert runner._fused_packed_wanted(Params(**base), "jax", None)
    assert not runner._fused_packed_wanted(Params(**base), "exact", None)
    assert not runner._fused_packed_wanted(Params(**base), "jax", object())
    assert not runner._fused_packed_wanted(
        Params(**{**base, "in_geno": "-"}), "jax", None)
    assert not runner._fused_packed_wanted(
        Params(**{**base, "call_geno": True}), "jax", None)
    assert not runner._fused_packed_wanted(
        Params(**{**base, "evol_model": 4}), "jax", None)
    assert not runner._fused_packed_wanted(
        Params(**{**base, "verbose": 8}), "jax", None)
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    assert not runner._fused_packed_wanted(Params(**base), "jax", None)


def test_runner_end_to_end_fused(tmp_path, monkeypatch, f32_engine):
    """Full runner.run through the fused path == staged output file."""
    from ngsdist_jax import runner

    S, N = 200, 6
    path, _ = _write_gp(str(tmp_path), S, N, seed=7)

    def run(tag, fused_env):
        monkeypatch.setenv("NGSDIST_FUSED_READ", fused_env)
        out = os.path.join(str(tmp_path), f"{tag}.dist")
        pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                      n_sites=S, indep_geno=True, pairwise_del=True,
                      evol_model=0, seed=1, verbose=0, out=out)
        runner.run(pars, engine="jax")
        with open(out) as fh:
            return fh.read()

    assert run("fused", "auto") == run("staged", "0")


# ------------------------------------------------------------------ #
# Fused CODES reader (default-threshold --call_geno, nd_read_geno_codes)
# ------------------------------------------------------------------ #

def _write_gp_calls(tmp_path, S, N, seed=9, miss=True, name="gpm.bin"):
    """Binary GP whose default-threshold call_geno output exercises all
    codes: clear one-hots, near-ties (first-argmax order), and (when
    miss=True) exactly all-equal triples -> the uniform missing code."""
    rng = np.random.default_rng(seed)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    g[1 % S, 0] = [0.4, 0.4, 0.2]       # tie on the max: first argmax
    g[2 % S, 1 % N] = [1, 0, 0]
    if miss:
        g[7 % S, 2 % N] = [0.25, 0.25, 0.25]   # all-equal -> missing
        g[S - 1, N - 1] = [1 / 3, 1 / 3, 1 / 3]
    path = os.path.join(tmp_path, name)
    g.astype(np.float64).tofile(path)
    return path, g


def _staged_codes(path, in_logscale, N, S):
    from ngsdist_jax.utils.hostmem import derive_codes

    P = preprocess(readers.read_geno(path, True, True, in_logscale, N, S),
                   True, 0.0, 0.0)
    got = derive_codes(P)
    assert got is not None
    return P, got


@pytest.mark.parametrize("miss", [True, False])
def test_codes_bit_equal_staged(tmp_path, miss):
    """codes + lut + lazy-P reconstruction all bit-equal to the staged
    read -> call_geno -> exp -> derive_codes pipeline."""
    from ngsdist_jax.utils.hostmem import CodedProbs, coded_call_lut

    S, N = 257, 13
    path, g = _write_gp_calls(str(tmp_path), S, N, miss=miss)
    P, (codes_s, lut_s) = _staged_codes(path, False, N, S)
    got = readers.read_geno_codes(path, False, N, S)
    assert got is not None
    codes_f, any_missing = got
    assert any_missing == miss
    np.testing.assert_array_equal(codes_s, codes_f)
    lut_f = coded_call_lut(any_missing)
    np.testing.assert_array_equal(lut_s, lut_f)
    # lazy CodedProbs: slicing stays lazy; materialization reconstructs
    # the exact staged f64 tensor
    lazy = CodedProbs(None, codes_f, lut_f)
    assert lazy.shape == (S, N, 3) and lazy.dtype == np.float64
    sl = lazy[40:90]
    assert sl._P is None and lazy._P is None
    np.testing.assert_array_equal(sl.codes, codes_f[40:90])
    np.testing.assert_array_equal(np.asarray(sl), P[40:90])
    np.testing.assert_array_equal(np.asarray(lazy), P)

    # log-scale input and ranged reads
    logp = os.path.join(str(tmp_path), "glm.bin")
    np.log(np.maximum(g, 1e-300)).tofile(logp)
    _, (codes_ls, _) = _staged_codes(logp, True, N, S)
    got_l = readers.read_geno_codes(logp, True, N, S)
    np.testing.assert_array_equal(codes_ls, got_l[0])
    ranged = readers.read_geno_codes(path, False, N, S, site_range=(30, 200))
    np.testing.assert_array_equal(codes_f[30:200], ranged[0])


def test_codes_error_surface_and_gz(tmp_path):
    import gzip
    import shutil

    S, N = 48, 4
    path, g = _write_gp_calls(str(tmp_path), S, N)
    with open(path, "rb") as fh:
        buf = fh.read()
    trunc = os.path.join(str(tmp_path), "ctrunc.bin")
    with open(trunc, "wb") as fh:
        fh.write(buf[:-40])
    with pytest.raises(NgsDistError, match="premature EOF"):
        readers.read_geno_codes(trunc, False, N, S)

    gn = g.copy()
    gn[3, 1] = np.nan
    nanp = os.path.join(str(tmp_path), "cnan.bin")
    gn.tofile(nanp)
    with pytest.raises(NgsDistError, match="NaN found"):
        readers.read_geno_codes(nanp, False, N, S)

    gz = os.path.join(str(tmp_path), "cgz.bin")
    with open(path, "rb") as s, gzip.open(gz, "wb") as d:
        shutil.copyfileobj(s, d)
    assert readers.read_geno_codes(gz, False, N, S) is None


def test_fused_coded_gating(tmp_path, monkeypatch, f32_engine):
    """_fused_coded_wanted: deferred handle for single-device raw-binary
    f32 jax runs with DEFAULT-threshold call_geno and coded uploads on;
    eager resident plane for mesh runs (plane under the host budget)
    and chunked bootstrap; False otherwise."""
    from ngsdist_jax import runner

    S, N = 16, 3
    path, _ = _write_gp_calls(str(tmp_path), S, N, seed=2)
    base = dict(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                n_sites=S, indep_geno=True, call_geno=True, verbose=0)
    assert runner._fused_coded_wanted(Params(**base), "jax", None) == "handle"
    assert not runner._fused_coded_wanted(Params(**base), "exact", None)
    assert not runner._fused_coded_wanted(
        Params(**{**base, "call_geno": False}), "jax", None)
    assert not runner._fused_coded_wanted(
        Params(**{**base, "call_thresh": 0.9}), "jax", None)
    assert not runner._fused_coded_wanted(
        Params(**{**base, "in_geno": "-"}), "jax", None)
    assert not runner._fused_coded_wanted(
        Params(**{**base, "evol_model": 4}), "jax", None)
    assert not runner._fused_coded_wanted(
        Params(**{**base, "verbose": 8}), "jax", None)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
    assert not runner._fused_coded_wanted(Params(**base), "jax", None)
    monkeypatch.delenv("NGSDIST_CODED_UPLOAD")
    monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
    assert not runner._fused_coded_wanted(Params(**base), "jax", None)
    monkeypatch.delenv("NGSDIST_FUSED_READ")
    # mesh runs need the resident plane; over the host budget they
    # fall through to LAZY coded rounds (wants_coded_lazy) instead
    mesh = object()
    assert runner._fused_coded_wanted(Params(**base), "jax", mesh) == "eager"
    monkeypatch.setenv("NGSDIST_HOST_BUDGET", str(S * N))
    assert not runner._fused_coded_wanted(Params(**base), "jax", mesh)
    # over-budget with NO mesh on a MULTI-device host (8 virtual test
    # devices): defer to the lazy stream's auto-mesh (lazy coded
    # rounds shard compute) rather than a single-device handle
    assert not runner._fused_coded_wanted(Params(**base), "jax", None)
    monkeypatch.delenv("NGSDIST_HOST_BUDGET")
    # chunked bootstrap prefers the resident plane over per-replicate
    # disk re-reads through the handle
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "10")
    boot = Params(**{**base, "n_boot_rep": 2, "boot_block_size": 4})
    assert runner._fused_coded_wanted(boot, "jax", None) == "eager"
    assert runner._fused_coded_wanted(Params(**base), "jax", None) == "handle"


def test_runner_end_to_end_coded(tmp_path, monkeypatch, f32_engine):
    """Full runner.run through the fused codes path == the staged
    call_geno pipeline's output file, resident and chunked."""
    from ngsdist_jax import runner

    S, N = 220, 6
    path, _ = _write_gp_calls(str(tmp_path), S, N, seed=7)
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")

    def run(tag, fused_env, budget=None):
        monkeypatch.setenv("NGSDIST_FUSED_READ", fused_env)
        if budget is not None:
            monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
        else:
            monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
        out = os.path.join(str(tmp_path), f"{tag}.dist")
        pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                      n_sites=S, indep_geno=True, pairwise_del=True,
                      call_geno=True, evol_model=0, seed=1, verbose=0,
                      out=out)
        runner.run(pars, engine="jax")
        with open(out) as fh:
            return fh.read()

    want = run("staged", "0")
    assert run("coded", "auto") == want
    assert run("coded_chunk", "auto", budget=40000) == want


@pytest.mark.parametrize("budget", [None, 40000])
def test_engine_matches_staged_coded_handle(tmp_path, monkeypatch,
                                            f32_engine, budget):
    """CodedBinInput (deferred coded chunks) vs the staged call_geno
    pipeline: identical matrices on the resident (pipelined coded
    upload) and chunked (per-chunk fused code reads) streams,
    including bootstrap replicates."""
    monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
    if budget is not None:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    S, N = 600, 8
    path, _ = _write_gp_calls(str(tmp_path), S, N, seed=13)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, indep_geno=True, pairwise_del=True,
                  call_geno=True, evol_model=1, seed=5, n_boot_rep=2,
                  boot_block_size=10, verbose=0,
                  out=os.path.join(str(tmp_path), "o.dist"))
    pars.validate()
    pars.finalize()

    staged_P = preprocess(
        readers.read_geno(path, True, True, False, N, S), True, 0.0, 0.0)
    want = _run_engine(pars, staged_P)
    got = _run_engine(pars, readers.CodedBinInput(pars))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


# ------------------------------------------------------------------ #
# Fused uint16-quantized reader (NGSDIST_UPLOAD16, nd_read_geno_pack16)
# ------------------------------------------------------------------ #

def _write_gp_u16(tmp_path, S, N, seed=13, name="gpu.bin"):
    rng = np.random.default_rng(seed)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    g[5 % S, 3 % N] = [1, 0, 0]
    g[S - 1, N - 1] = [0, 0, 1]
    g[7 % S, 2 % N] = [0.25, 0.25, 0.25]      # all-equal -> sentinel
    g[11 % S, 0] = [1 / 3, 1 / 3, 1 / 3]
    path = os.path.join(tmp_path, name)
    g.astype(np.float64).tofile(path)
    return path, g


def test_pack16_fused_bit_equal_staged(tmp_path, monkeypatch):
    """One native pass == staged read -> preprocess -> pack16 (same
    libm order; llrint == np.rint round-half-even), incl. the
    host-missing sentinel rows and ranged reads."""
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    S, N = 301, 17
    path, _ = _write_gp_u16(str(tmp_path), S, N)
    fused = readers.read_geno_pack16(path, False, N, S)
    assert fused is not None and fused.dtype == np.uint16
    staged = pack23(preprocess(
        readers.read_geno(path, True, True, False, N, S), False, 0.0, 0.0),
        np.float32, may_zero=False)
    assert staged.dtype == np.uint16
    np.testing.assert_array_equal(staged, fused)
    # sentinel on the all-equal triples
    assert fused[7 % S, 2 % N, 0] == 65535
    assert fused[11 % S, 0, 0] == 65535
    ranged = readers.read_geno_pack16(path, False, N, S,
                                      site_range=(40, 190))
    np.testing.assert_array_equal(staged[40:190], ranged)


def test_pack16_handle_lane_and_bytes(tmp_path, monkeypatch):
    S, N = 32, 5
    path, _ = _write_gp_u16(str(tmp_path), S, N)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, indep_geno=True, verbose=0,
                  out=os.path.join(str(tmp_path), "o.dist"))
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    h16 = readers.PackedBinInput(pars)
    assert h16.u16 and h16.bytes_per_site == N * 4
    assert h16.read_packed(0, 4).dtype == np.uint16
    monkeypatch.setenv("NGSDIST_UPLOAD16", "0")
    h32 = readers.PackedBinInput(pars)
    assert not h32.u16 and h32.bytes_per_site == N * 8
    assert h32.read_packed(0, 4).dtype == np.float32


@pytest.mark.parametrize("budget", [None, 40000])
def test_engine_matches_staged_u16(tmp_path, monkeypatch, f32_engine,
                                   budget):
    """u16 fused handle vs u16 staged tensor path: identical matrices
    (both routes quantize identically), resident and chunked, incl.
    bootstrap replicates."""
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    if budget is not None:
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(budget))
    S, N = 600, 8
    path, _ = _write_gp_u16(str(tmp_path), S, N, seed=21)
    pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                  n_sites=S, indep_geno=True, pairwise_del=True,
                  evol_model=1, seed=5, n_boot_rep=2, boot_block_size=10,
                  verbose=0, out=os.path.join(str(tmp_path), "o.dist"))
    pars.validate()
    pars.finalize()
    staged_P = preprocess(
        readers.read_geno(path, True, True, False, N, S), False, 0.0, 0.0)
    want = _run_engine(pars, staged_P)
    got = _run_engine(pars, readers.PackedBinInput(pars))
    assert len(want) == len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_runner_end_to_end_u16(tmp_path, monkeypatch, f32_engine):
    """runner.run: fused u16 == staged u16 byte-for-byte; u16 vs the
    f32 lane stays within the documented quantization class."""
    from ngsdist_jax import runner

    S, N = 200, 6
    path, _ = _write_gp_u16(str(tmp_path), S, N, seed=8)

    def run(tag, fused_env, u16_env):
        monkeypatch.setenv("NGSDIST_FUSED_READ", fused_env)
        monkeypatch.setenv("NGSDIST_UPLOAD16", u16_env)
        out = os.path.join(str(tmp_path), f"{tag}.dist")
        pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                      n_sites=S, indep_geno=True, pairwise_del=True,
                      evol_model=0, seed=1, verbose=0, out=out)
        runner.run(pars, engine="jax")
        with open(out) as fh:
            return fh.read()

    fused_u16 = run("fused16", "auto", "1")
    assert fused_u16 == run("staged16", "0", "1")

    def mat(txt):
        rows = [ln.split() for ln in txt.splitlines() if ln.strip()]
        return np.array([[float(v) for v in r[1:]] for r in rows
                         if len(r) > 2])

    f32 = run("staged32", "0", "0")
    assert np.abs(mat(fused_u16) - mat(f32)).max() < 5e-5


def test_codes_near_tie_log_collision(tmp_path):
    """Rounding-collision regression (round-5 review): distinct raw
    doubles can share a rounded log, so the staged log-space
    classification sees a first-argmax tie where raw-space comparison
    sees strict order.  The libm-free fast path must route such
    near-ties through the exact staged arithmetic — fused and staged
    codes stay bit-identical."""
    S, N = 64, 4
    rng = np.random.default_rng(3)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    a = 0.333789750028358  # log(a) == log(nextafter(a, 1)) in f64
    b = np.nextafter(a, 1.0)
    g[0, 0] = [a, b, 1.0 - a - b]          # top-2 adjacent doubles
    g[1, 1] = [b, a, 1.0 - a - b]          # reversed order
    g[2, 2] = [a, a, 1.0 - 2 * a]          # exact tie (first argmax)
    g[3, 3] = [1 / 3, np.nextafter(1 / 3, 1.0), 1 / 3]  # near-uniform
    g[4, 0] = [0.5, np.nextafter(0.5, 0.0), # tie just below the guard
               0.5 - np.nextafter(0.5, 0.0)]
    path = os.path.join(str(tmp_path), "tie.bin")
    g.astype(np.float64).tofile(path)
    fused = readers.read_geno_codes(path, False, N, S)
    assert fused is not None
    _, (codes, _lut) = _staged_codes(path, False, N, S)
    np.testing.assert_array_equal(fused[0], codes)


def test_pack16_fast_path_boundary_guards(tmp_path, monkeypatch):
    """The libm-free pack16 fast path (direct p/sum normalize) must
    stay bit-identical to the staged route even at its guard
    boundaries: quantization products at half-integers, diffs at the
    EPSILON missing threshold, and near-subnormal triples."""
    monkeypatch.setenv("NGSDIST_UPLOAD16", "1")
    S, N = 32, 3
    rng = np.random.default_rng(5)
    g = rng.exponential(size=(S, N, 3))
    g /= g.sum(-1, keepdims=True)
    # half-integer quantization product: p = (k + 0.5)/65534 exactly
    g[0, 0] = [16383.5 / 65534, 0.5, 1 - 16383.5 / 65534 - 0.5]
    # diffs exactly at / within ulps of the 1e-5 missing threshold
    b = 1 / 3
    g[1, 1] = [b + 1e-5, b, 1 - 2 * b - 1e-5]
    g[2, 2] = [b + np.nextafter(1e-5, 0), b, 1 - 2 * b - 1e-5]
    g[3, 0] = [1e-301, 2e-301, 1 - 3e-301]  # near-subnormal components
    path = os.path.join(str(tmp_path), "b16.bin")
    g.astype(np.float64).tofile(path)
    fused = readers.read_geno_pack16(path, False, N, S)
    staged = pack23(preprocess(
        readers.read_geno(path, True, True, False, N, S), False, 0.0, 0.0),
        np.float32, may_zero=False)
    np.testing.assert_array_equal(staged, fused)
