"""Per-host shard reading and global sharded array assembly."""

import gzip

import numpy as np
import pytest

import jax

from ngsdist_jax.config import Params
from ngsdist_jax.core.preprocess import preprocess
from ngsdist_jax.io import readers
from ngsdist_jax.parallel import mesh as pm
from ngsdist_jax.parallel import multihost as mh


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(n_devices=8)


def _write_beagle(path, rng, S, N):
    with gzip.open(path, "wt") as fh:
        fh.write("marker\tallele1\tallele2\t" + "\t".join(
            f"Ind{i}" for i in range(N) for _ in range(3)) + "\n")
        for s in range(S):
            gl = rng.dirichlet(np.ones(3), size=N).reshape(-1)
            fh.write(f"m_{s}\t0\t1\t" + "\t".join(f"{x:.6f}" for x in gl) + "\n")


def test_site_range_binary(tmp_path):
    rng = np.random.default_rng(0)
    S, N = 50, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = str(tmp_path / "gp.bin")
    gp.tofile(path)
    full = readers.read_geno(path, True, True, False, N, S, native=False)
    part = readers.read_geno(path, True, True, False, N, S, site_range=(17, 42))
    np.testing.assert_array_equal(part, full[17:42])


def test_site_range_text_with_header(tmp_path):
    rng = np.random.default_rng(1)
    S, N = 30, 5
    path = str(tmp_path / "gl.beagle.gz")
    _write_beagle(path, rng, S, N)
    full = readers.read_geno(path, False, True, False, N, S, native=False)
    part = readers.read_geno(path, False, True, False, N, S, site_range=(10, 25))
    np.testing.assert_array_equal(part, full[10:25])


def test_load_global_probs_single_process(mesh8, tmp_path):
    rng = np.random.default_rng(2)
    S, N = 43, 4  # ragged
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = str(tmp_path / "gp.bin")
    gp.tofile(path)
    pars = Params(in_geno=path, in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="x", seed=1)
    arr, s_pad = mh.load_global_probs(pars, mesh8)
    assert s_pad % 8 == 0 and s_pad >= S
    host = np.asarray(arr)
    expect = preprocess(
        readers.read_geno(path, True, True, False, N, S, native=False),
        False, 0.0, 0.0,
    )
    np.testing.assert_allclose(host[:S], expect, atol=0)
    assert np.all(host[S:] == 0.0)


def test_host_site_range_covers_all(mesh8):
    start, stop = mh.host_site_range(80, mesh8)
    assert (start, stop) == (0, 80)  # single process owns everything


def test_lazy_stream_matches_eager(mesh8, tmp_path, monkeypatch):
    """A lazy SiteStream (host shard over NGSDIST_HOST_BUDGET, rounds
    read from disk via binary seeks) must produce the same sharded
    suffstats as the eager host-resident stream — host RAM no longer
    bounds genome length (beyond the reference's read_data.cpp:21
    bound)."""
    rng = np.random.default_rng(50)
    S, N = 96, 5
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = tmp_path / "gp.bin"
    gp.tofile(path)
    pars = Params(in_geno=str(path), in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="y", seed=3, indep_geno=True,
                  pairwise_del=True, verbose=0)

    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "100000000")
    monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
    eager = mh.SiteStream.from_reader(pars, mesh8, np.float64)
    assert not eager.lazy

    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "2000")
    lazy = mh.SiteStream.from_reader(pars, mesh8, np.float64)
    assert lazy.lazy and not lazy.resident and lazy.n_rounds > 1

    from ngsdist_jax.config import default_score_matrix
    from ngsdist_jax.parallel.mesh import sharded_suffstats

    score = default_score_matrix()

    def total(stream):
        acc_raw = acc_cnt = None
        w = np.ones((S,), np.float64)
        for r in range(stream.n_rounds):
            raw, cnt, _, _ = sharded_suffstats(
                stream.round_data(r), score, mesh8, indep=True,
                pairwise_del=True, site_weights=stream.round_cols(r, w),
                n_sites=stream.round_sites,
            )
            raw = np.asarray(raw, np.float64)
            cnt = np.asarray(cnt, np.float64)
            acc_raw = raw if acc_raw is None else acc_raw + raw
            acc_cnt = cnt if acc_cnt is None else acc_cnt + cnt
        return acc_raw, acc_cnt

    # identical chunking -> identical grouping: byte-equal sums
    assert eager.resident  # big device budget: eager is resident
    raw_l, cnt_l = total(lazy)
    monkeypatch.setenv("NGSDIST_DEVICE_BUDGET",
                       str(lazy.chunk * N * 3 * 8 * 4))
    monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
    eager_rounds = mh.SiteStream.from_reader(pars, mesh8, np.float64)
    if eager_rounds.chunk == lazy.chunk:
        raw_e, cnt_e = total(eager_rounds)
        np.testing.assert_array_equal(raw_l, raw_e)
        np.testing.assert_array_equal(cnt_l, cnt_e)
    else:  # chunk plans differ: values still agree to regroup rounding
        raw_e, cnt_e = total(eager_rounds)
        np.testing.assert_allclose(raw_l, raw_e, rtol=1e-12)
        np.testing.assert_allclose(cnt_l, cnt_e, rtol=0, atol=0)


def test_lazy_runner_end_to_end(tmp_path, monkeypatch):
    """runner.run with a tiny NGSDIST_HOST_BUDGET routes through the
    lazy stream (mesh auto-created) and reproduces the eager output."""
    from ngsdist_jax import runner

    rng = np.random.default_rng(51)
    S, N = 60, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = tmp_path / "gp.bin"
    gp.tofile(path)

    def run(out, env):
        for k, v in env.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        pars = Params(in_geno=str(path), in_bin=True, in_probs=True,
                      n_ind=N, n_sites=S, out=str(tmp_path / out),
                      seed=9, indep_geno=True, pairwise_del=True,
                      n_boot_rep=2, boot_block_size=7, verbose=0)
        pars.validate(); pars.finalize()
        return runner.run(pars, engine="jax")

    ref = run("eager.dist", {"NGSDIST_HOST_BUDGET": None})
    lazy = run("lazy.dist", {"NGSDIST_HOST_BUDGET": "1000"})
    assert len(ref) == len(lazy) == 3
    for a, b in zip(ref, lazy):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)


def test_lazy_stream_extended_models(mesh8, tmp_path, monkeypatch):
    """Lazy disk-streamed rounds through the EXTENDED sharded path
    (TN93 needs per-pair base frequencies + 3 class masks per round):
    must match the eager in-memory run."""
    from ngsdist_jax.core import bootstrap as bt
    from ngsdist_jax.core import distance as dist
    from ngsdist_jax.core.submodels import encode_alleles

    rng = np.random.default_rng(52)
    S, N = 64, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    path = tmp_path / "gp.bin"
    gp.tofile(path)
    bases = np.array(["A", "C", "G", "T"])
    rows = []
    for s in range(S):
        a, b = rng.choice(4, size=2, replace=False)
        rows.append(("chr1", str(s + 1), bases[a], bases[b]))
    alleles = encode_alleles(rows)

    pars = Params(in_geno=str(path), in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="y", seed=3, indep_geno=True,
                  pairwise_del=True, evol_model=6, n_boot_rep=1,
                  boot_block_size=4, verbose=0)
    n_trunc, maps = bt.site_maps(pars.seed, 1, S, 4)

    monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
    monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
    P = np.asarray(
        preprocess(readers.read_geno(str(path), True, True, False, N, S),
                   False, 0.0, 0.0))
    eager = list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh8,
                                      alleles=alleles))

    monkeypatch.setenv("NGSDIST_HOST_BUDGET", "1500")
    stream = mh.SiteStream.from_reader(pars, mesh8, np.float64)
    assert stream.lazy and stream.n_rounds > 1
    lazy = list(dist.iter_replicates(pars, stream, maps, n_trunc, mesh=mesh8,
                                     alleles=alleles))
    assert len(eager) == len(lazy) == 2
    for a, b in zip(eager, lazy):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)


# ------------------------- spill caches (gz/text lazy) ----------------- #


def _write_text_gp(path, gp, gz=True):
    """Plain TSV GP: 3 probs per individual per line."""
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        for s in range(gp.shape[0]):
            fh.write("\t".join(f"{x:.6f}" for x in gp[s].reshape(-1)) + "\n")


def test_spill_text_geno_matches_eager_rows(tmp_path):
    """The text spill cache must hold BIT-IDENTICAL rows to the eager
    reader (same native parse), and read_spill_rows must return them
    without re-normalizing."""
    rng = np.random.default_rng(60)
    S, N = 37, 5
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    txt = tmp_path / "gp.tsv.gz"
    _write_text_gp(txt, gp)

    eager = readers.read_geno(str(txt), False, True, False, N, S)
    cache = tmp_path / "spill.bin"
    readers.spill_text_geno(str(txt), True, False, N, S, str(cache))
    rows = readers.read_spill_rows(str(cache), N, 0, S)
    np.testing.assert_array_equal(rows, eager)

    # ranged spill: only [11, 29)
    cache2 = tmp_path / "spill2.bin"
    readers.spill_text_geno(str(txt), True, False, N, S, str(cache2),
                            site_range=(11, 29))
    rows2 = readers.read_spill_rows(str(cache2), N, 11, 29, base=11)
    np.testing.assert_array_equal(rows2, eager[11:29])

    # python fallback agrees with the native spill (to the documented
    # 1-ulp numpy-vs-glibc log/exp difference, readers.py docstring)
    cache3 = tmp_path / "spill3.bin"
    readers.spill_text_geno(str(txt), True, False, N, S, str(cache3),
                            native=False)
    rows3 = readers.read_spill_rows(str(cache3), N, 0, S)
    np.testing.assert_allclose(rows3, rows, rtol=1e-15, atol=0)


def test_spill_text_geno_empty_line_missing(tmp_path):
    """Empty lines consume their site as missing in the spill cache,
    exactly like the eager prefill (-BIGNEG rows)."""
    rng = np.random.default_rng(61)
    S, N = 8, 3
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    txt = tmp_path / "gp.tsv"
    lines = ["\t".join(f"{x:.6f}" for x in gp[s].reshape(-1))
             for s in range(S)]
    lines[3] = ""  # site 3 -> missing
    txt.write_text("\n".join(lines) + "\n")

    eager = readers.read_geno(str(txt), False, True, False, N, S)
    cache = tmp_path / "spill.bin"
    readers.spill_text_geno(str(txt), True, False, N, S, str(cache))
    rows = readers.read_spill_rows(str(cache), N, 0, S)
    np.testing.assert_array_equal(rows, eager)
    assert np.all(rows[3] == -readers.BIGNEG)


def test_spill_gz_text_lazy_run_matches_eager(tmp_path, monkeypatch):
    """runner.run on a .tsv.gz GP with a tiny NGSDIST_HOST_BUDGET goes
    lazy via the text spill cache and reproduces the eager output —
    host RAM no longer bounds genome length on gz-text inputs either
    (VERDICT r2 #5; the reference dies at read time,
    read_data.cpp:21)."""
    from ngsdist_jax import runner

    rng = np.random.default_rng(62)
    S, N = 60, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    txt = tmp_path / "gp.tsv.gz"
    _write_text_gp(txt, gp)
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(spill_dir))

    def run(out, budget):
        if budget is None:
            monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
        else:
            monkeypatch.setenv("NGSDIST_HOST_BUDGET", budget)
        pars = Params(in_geno=str(txt), in_bin=False, in_probs=True,
                      n_ind=N, n_sites=S, out=str(tmp_path / out),
                      seed=9, indep_geno=True, pairwise_del=True,
                      n_boot_rep=2, boot_block_size=7, verbose=0)
        pars.validate(); pars.finalize()
        return runner.run(pars, engine="jax")

    ref = run("eager.dist", None)
    lazy = run("lazy.dist", "1000")
    assert len(ref) == len(lazy) == 3
    for a, b in zip(ref, lazy):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)
    # byte-identical phylip output, and the spill cache was cleaned up
    assert (tmp_path / "lazy.dist").read_bytes() == \
        (tmp_path / "eager.dist").read_bytes()
    assert list(spill_dir.iterdir()) == []


def test_spill_stdin_binary_lazy_run_matches_eager(tmp_path, monkeypatch):
    """STDIN is always BINARY in the reference contract (finalize) and
    cannot seek: over the host budget it spills a verbatim copy;
    rounds then normalize per read exactly like direct seekable-binary
    lazy runs.  Even stdin streams no longer bound genome length by
    host RAM."""
    import io
    import sys
    import types

    from ngsdist_jax import runner

    rng = np.random.default_rng(63)
    S, N = 60, 4
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    binp = tmp_path / "gp.bin"
    binp.write_bytes(gp.tobytes())
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(spill_dir))

    def run(out, budget, geno):
        if budget is None:
            monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
        else:
            monkeypatch.setenv("NGSDIST_HOST_BUDGET", budget)
        if geno == "-":
            monkeypatch.setattr(
                sys, "stdin",
                types.SimpleNamespace(buffer=io.BytesIO(gp.tobytes())))
        pars = Params(in_geno=geno, in_bin=True, in_probs=True,
                      n_ind=N, n_sites=S, out=str(tmp_path / out),
                      seed=5, indep_geno=True, pairwise_del=True,
                      verbose=0)
        pars.validate(); pars.finalize()
        return runner.run(pars, engine="jax")

    ref = run("eager.dist", None, str(binp))
    lazy = run("lazy.dist", "1000", "-")
    for a, b in zip(ref, lazy):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)
    assert list(spill_dir.iterdir()) == []


def test_spill_binary_copy_size_fatals(tmp_path, monkeypatch):
    """The binary copy-spill reproduces the reference's read-time size
    fatals: short stream -> premature EOF, long stream -> not at EOF."""
    from ngsdist_jax.config import NgsDistError

    rng = np.random.default_rng(64)
    S, N = 16, 3
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(tmp_path))

    short = tmp_path / "short.bin.gz"
    with gzip.open(short, "wb") as fh:
        fh.write(gp.tobytes()[:-8])
    pars = Params(in_geno=str(short), in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="y", seed=1, verbose=0)
    with pytest.raises(NgsDistError, match="premature EOF"):
        mh.SiteStream._build_spill(pars, 0, S)

    longf = tmp_path / "long.bin.gz"
    with gzip.open(longf, "wb") as fh:
        fh.write(gp.tobytes() + b"x")
    pars = Params(in_geno=str(longf), in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="y", seed=1, verbose=0)
    with pytest.raises(NgsDistError, match="not at EOF"):
        mh.SiteStream._build_spill(pars, 0, S)
    # failed spills leave no cache behind
    assert [p for p in tmp_path.iterdir() if p.name.startswith("ngsdist_spill")] == []


def test_spill_binary_shard_only(tmp_path, monkeypatch, mesh8):
    """Each process's verbatim binary spill holds ONLY its own site
    shard (total disk across P processes = one genome, not P genomes),
    and lazy round reads rebase into the shard cache correctly."""
    import os

    rng = np.random.default_rng(65)
    S, N = 30, 3
    gp = rng.dirichlet(np.ones(3), size=(S, N))
    gz = tmp_path / "gp.bin.gz"
    with gzip.open(gz, "wb") as fh:
        fh.write(gp.tobytes())
    monkeypatch.setenv("NGSDIST_SPILL_DIR", str(tmp_path))
    pars = Params(in_geno=str(gz), in_bin=True, in_probs=True,
                  n_ind=N, n_sites=S, out="y", seed=1, verbose=0)
    row = N * 3 * 8
    # shard [16, 32) of an s_pad=32 mesh split — clamped to [16, S)
    spill = mh.SiteStream._build_spill(pars, 16, 32)
    try:
        assert spill["spill_base"] == 16
        assert os.path.getsize(spill["spill_path"]) == (S - 16) * row
        got = np.fromfile(spill["spill_path"]).reshape(-1, N, 3)
        np.testing.assert_array_equal(got, gp[16:])
        # a lazy stream over this shard rebases its round reads
        stream = mh.SiteStream(pars, mesh8, np.float64, None,
                               s_pad=32, chunk=2, start=16, stop=32,
                               **spill)
        rows = stream._read_rows(18, 22)
        eager = readers.read_geno(str(gz), True, True, False, N, S,
                                  site_range=(18, 22))
        np.testing.assert_array_equal(rows, eager)
    finally:
        mh.SiteStream._rm_spill(spill["spill_path"])
