"""Coded uint8 uploads (NGSDIST_CODED_UPLOAD).

Hard-genotype inputs (/root/reference/shared/read_data.cpp:87-95: every
triple one-hot or uniform log(1/3)) and default-threshold --call_geno
runs (gen_func.cpp:886-914) produce tensors drawn from a handful of
distinct triples.  The jax engine uploads ONE uint8 code per
(site, individual) plus a tiny lookup table and expands on device — 8x
fewer host-link bytes than the packed f32 slab, and bit-faithful: the
expansion equals the engine-dtype cast of the f64 triple (no pack23
p2-reconstruction error).  These tests pin (a) derive_codes detection
and bail-out, (b) expansion exactness through put_probs, (c) engine
sufficient statistics vs the staged upload, and (d) the end-to-end CLI
surface (resident + forced-chunked) against the staged pipeline.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from ngsdist_jax.core import distance as dist
from ngsdist_jax.utils.hostmem import CodedProbs, derive_codes

SCORE = np.array([[0, 0.5, 1], [0.5, 0, 0.5], [1, 0.5, 0]])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "fixtures", "data")


def _coded_tensor(S, N, seed=0):
    """One-hot / uniform tensor like the reader's genotype output."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(S, N))
    P = np.zeros((S, N, 3))
    for k in range(3):
        P[..., k] = g == k
    miss = rng.random((S, N)) < 0.15
    # the reader's uniform value is exp(log(1/3) - logsum), not a
    # round 1/3 — use a value with the same "not exactly representable
    # as a sum-to-1 triple" character
    v = np.exp(np.log(1.0 / 3.0))
    P[miss] = v
    return P, g, miss, v


class TestDeriveCodes:
    def test_detects_and_roundtrips(self):
        P, g, miss, v = _coded_tensor(300, 9)
        got = derive_codes(P)
        assert got is not None
        codes, lut = got
        assert codes.dtype == np.uint8 and lut.dtype == np.float64
        # expansion reproduces the tensor exactly (f64 table)
        np.testing.assert_array_equal(lut[codes], P)
        np.testing.assert_array_equal(codes >= 3, miss)

    def test_bails_on_real_probs(self):
        rng = np.random.default_rng(1)
        P = rng.dirichlet(np.ones(3), size=(40, 4))
        assert derive_codes(P) is None

    def test_bails_on_mixed_thresholded(self):
        # thresholded call_geno leaves mid-confidence triples untouched
        P, _, _, _ = _coded_tensor(50, 4)
        P[10, 2] = [0.2, 0.5, 0.3]
        assert derive_codes(P) is None

    def test_two_uniform_values(self):
        # reader uniform + empty-line all-zero triples coexist
        P, _, _, _ = _coded_tensor(60, 4, seed=2)
        P[7, :] = 0.0
        got = derive_codes(P)
        assert got is not None
        codes, lut = got
        np.testing.assert_array_equal(lut[codes], P)

    def test_coded_probs_slicing(self):
        P, _, _, _ = _coded_tensor(80, 5)
        codes, lut = derive_codes(P)
        w = CodedProbs(P, codes, lut)
        assert w.shape == P.shape and len(w) == 80
        sub = w[10:30]
        assert isinstance(sub, CodedProbs)
        np.testing.assert_array_equal(sub.codes, codes[10:30])
        np.testing.assert_array_equal(np.asarray(w), P)
        # non-slice access decays to the tensor
        assert not isinstance(w[0], CodedProbs)


class TestPutProbs:
    def test_expansion_is_exact_cast(self, monkeypatch):
        P, _, _, _ = _coded_tensor(200, 8)
        codes, lut = derive_codes(P)
        w = CodedProbs(P, codes, lut)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        Pd = np.asarray(dist.put_probs(w, jnp.float32))
        # bit-faithful: the f32 cast of the f64 triples, including the
        # uniform value's third component (pack23 would reconstruct it
        # as 1 - v - v instead)
        np.testing.assert_array_equal(Pd, P.astype(np.float32))

    def test_disabled_falls_back(self, monkeypatch):
        P, _, _, _ = _coded_tensor(100, 6, seed=3)
        codes, lut = derive_codes(P)
        w = CodedProbs(P, codes, lut)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
        monkeypatch.setenv("NGSDIST_UPLOAD23", "0")
        Pd = np.asarray(dist.put_probs(w, jnp.float32))
        np.testing.assert_array_equal(Pd, P.astype(np.float32))

    def test_suffstats_match_staged_upload(self, monkeypatch):
        P, _, _, _ = _coded_tensor(400, 10, seed=4)
        codes, lut = derive_codes(P)
        score = jnp.asarray(SCORE, jnp.float32)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
        monkeypatch.setenv("NGSDIST_UPLOAD23", "0")
        Pd0 = dist.put_probs(CodedProbs(P, codes, lut), jnp.float32)
        r0, c0 = dist.indep_suffstats(Pd0, score, True)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        Pd1 = dist.put_probs(CodedProbs(P, codes, lut), jnp.float32)
        r1, c1 = dist.indep_suffstats(Pd1, score, True)
        # identical device tensors -> identical statistics
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))


@pytest.mark.slow
class TestEndToEnd:
    """CLI surface in an f32 (x64-off) subprocess — the device
    numeric regime where coded uploads auto-enable."""

    def _run(self, tmp_path, tag, extra_env):
        out = str(tmp_path / f"{tag}.dist")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
        env.update(extra_env)
        # --platform cpu pins the backend (f32: no --x64), the regime
        # where coded uploads auto-enable
        cmd = [sys.executable, "-m", "ngsdist_jax",
               "--geno", os.path.join(DATA, "gt.geno.gz"),
               "--n_ind", "20", "--n_sites", "1200",
               "--labels", os.path.join(DATA, "labels.txt"),
               "--pairwise_del", "--out", out, "--engine", "jax",
               "--platform", "cpu"]
        r = subprocess.run(cmd, env=env, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]
        return out

    @staticmethod
    def _matrix(path):
        rows = []
        with open(path) as fh:
            lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
        for ln in lines[1:]:
            rows.append([float(x) for x in ln.split("\t")[1:]])
        return np.asarray(rows)

    def test_geno_input_resident_and_chunked(self, tmp_path):
        base = self._run(tmp_path, "staged", {"NGSDIST_CODED_UPLOAD": "0"})
        coded = self._run(tmp_path, "coded", {"NGSDIST_CODED_UPLOAD": "1"})
        # forced-chunked: streams CodedProbs slices through
        # _pipelined_chunks (uint8 chunks on the link)
        chunked = self._run(tmp_path, "coded_chunk",
                            {"NGSDIST_CODED_UPLOAD": "1",
                             "NGSDIST_DEVICE_BUDGET": "100000"})
        M0 = self._matrix(base)
        np.testing.assert_allclose(self._matrix(coded), M0, rtol=0, atol=2e-6)
        np.testing.assert_array_equal(self._matrix(chunked),
                                      self._matrix(coded))


class TestMesh:
    """Coded shards on the device mesh: SiteStream stores the uint8
    code plane itself (24x less shard RAM, 8x fewer link bytes) and
    expands rounds on device.  Forced on under the f64 test mesh, the
    lut expansion is the exact f64 tensor, so sharded results must be
    BIT-identical to the staged upload."""

    @pytest.fixture()
    def mesh8(self):
        from ngsdist_jax.parallel import mesh as pm

        return pm.make_mesh(n_devices=8)

    def _mats(self, pars, P, mesh):
        from ngsdist_jax.core import bootstrap as bt
        from ngsdist_jax.core import distance as dist

        n_trunc, maps = bt.site_maps(
            pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size)
        return list(dist.iter_replicates(pars, P, maps, n_trunc, mesh=mesh))

    @pytest.mark.parametrize("pairwise_del", [False, True])
    def test_sharded_resident_and_streamed(self, mesh8, monkeypatch,
                                           pairwise_del):
        from ngsdist_jax.config import Params
        from ngsdist_jax.parallel.multihost import SiteStream

        P, _, _, _ = _coded_tensor(141, 5, seed=7)
        codes, lut = derive_codes(P)
        w = CodedProbs(P, codes, lut)
        pars = Params(in_geno="x", n_ind=5, n_sites=141, out="y", seed=3,
                      indep_geno=True, pairwise_del=pairwise_del,
                      in_probs=False, n_boot_rep=2, boot_block_size=4,
                      evol_model=1)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        monkeypatch.delenv("NGSDIST_DEVICE_BUDGET", raising=False)
        st = SiteStream.from_array(w, pars, mesh8, np.float64)
        assert st.coded and st.resident
        # the coded shard is the uint8 plane, not the f64 tensor
        assert st.local.dtype == np.uint8 and st.local.ndim == 2
        base = self._mats(pars, P, mesh8)
        got = self._mats(pars, w, mesh8)
        assert len(got) == len(base) == 3
        for a, b in zip(base, got):
            np.testing.assert_array_equal(b, a)
        # forced rounds: the code plane streams through round_data
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", str(4 * 5 * 3 * 8))
        st2 = SiteStream.from_array(w, pars, mesh8, np.float64)
        assert st2.coded and not st2.resident and st2.n_rounds > 1
        streamed = self._mats(pars, w, mesh8)
        for a, b in zip(base, streamed):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-11)

    def test_disabled_decays_to_staged(self, mesh8, monkeypatch):
        from ngsdist_jax.config import Params
        from ngsdist_jax.parallel.multihost import SiteStream

        P, _, _, _ = _coded_tensor(60, 4, seed=8)
        codes, lut = derive_codes(P)
        w = CodedProbs(P, codes, lut)
        pars = Params(in_geno="x", n_ind=4, n_sites=60, out="y", seed=3,
                      indep_geno=True, in_probs=False, evol_model=1)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
        st = SiteStream.from_array(w, pars, mesh8, np.float64)
        assert not st.coded
        np.testing.assert_array_equal(
            np.asarray(st.global_array())[:60], P)

    def test_pad_lut(self):
        from ngsdist_jax.utils.hostmem import coded_pad_lut

        lut = np.zeros((4, 3))
        lut[0, 0] = lut[1, 1] = lut[2, 2] = 1.0
        lut[3] = 1 / 3
        lut2, pc = coded_pad_lut(lut)
        assert lut2.shape == (5, 3) and pc == 4 and not lut2[pc].any()
        # an existing zero row is reused
        lut3, pc3 = coded_pad_lut(lut2)
        assert lut3.shape == (5, 3) and pc3 == 4


class TestLazyCoded:
    """LAZY coded rounds: over-host-budget default-threshold --call_geno
    binary runs read uint8 codes straight from disk per round
    (SiteStream._read_codes via the fused nd_read_geno_codes) — 24x
    less round staging and 8x fewer link bytes than the staged
    read -> preprocess -> pack round path, with BIT-identical results
    (the lut expansion IS the staged f64 triple)."""

    @pytest.fixture()
    def mesh8(self):
        from ngsdist_jax.parallel import mesh as pm

        return pm.make_mesh(n_devices=8)

    def _gp(self, tmp_path, S, N, seed=21, gz=False):
        rng = np.random.default_rng(seed)
        g = rng.dirichlet(np.ones(3), size=(S, N))
        g[5 % S, 1 % N] = [0.25, 0.25, 0.25]     # all-equal -> missing
        g[9 % S, 0] = [0.4, 0.4, 0.2]            # max tie: first argmax
        path = os.path.join(str(tmp_path), "gp.bin")
        g.astype(np.float64).tofile(path)
        if gz:
            import gzip
            import shutil

            gzp = os.path.join(str(tmp_path), "gp.bin.gz")
            with open(path, "rb") as s, gzip.open(gzp, "wb") as d:
                shutil.copyfileobj(s, d)
            return gzp
        return path

    def _pars(self, path, S, N):
        from ngsdist_jax.config import Params

        pars = Params(in_geno=path, in_bin=True, in_probs=True, n_ind=N,
                      n_sites=S, out="y", seed=3, indep_geno=True,
                      call_geno=True, pairwise_del=True, evol_model=1,
                      n_boot_rep=2, boot_block_size=4, verbose=0)
        return pars

    def _mats(self, pars, stream, mesh):
        from ngsdist_jax.core import bootstrap as bt

        n_trunc, maps = bt.site_maps(
            pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size)
        return list(dist.iter_replicates(pars, stream, maps, n_trunc,
                                         mesh=mesh))

    @pytest.mark.parametrize("gz", [False, True])
    def test_lazy_coded_matches_staged_lazy(self, mesh8, tmp_path,
                                            monkeypatch, gz):
        from ngsdist_jax.parallel.multihost import SiteStream

        S, N = 120, 5
        path = self._gp(tmp_path, S, N, gz=gz)
        pars = self._pars(path, S, N)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "2000")
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "100000000")

        monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
        staged = SiteStream.from_reader(pars, mesh8, np.float64)
        assert staged.lazy and not staged.coded and staged.n_rounds > 1
        want = self._mats(pars, staged, mesh8)
        staged.close()

        monkeypatch.setenv("NGSDIST_FUSED_READ", "auto")
        coded = SiteStream.from_reader(pars, mesh8, np.float64)
        assert coded.lazy and coded.coded and coded.local is None
        assert coded.chunk == staged.chunk  # same plan -> same grouping
        got = self._mats(pars, coded, mesh8)
        coded.close()
        assert len(want) == len(got) == 3
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)

    def test_gates(self, monkeypatch, tmp_path):
        from ngsdist_jax.parallel.multihost import SiteStream

        S, N = 16, 3
        path = self._gp(tmp_path, S, N)
        base = self._pars(path, S, N)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        assert SiteStream.wants_coded_lazy(base, np.float64)

        import dataclasses

        assert not SiteStream.wants_coded_lazy(
            dataclasses.replace(base, call_geno=False), np.float64)
        assert not SiteStream.wants_coded_lazy(
            dataclasses.replace(base, call_thresh=0.9), np.float64)
        # text inputs are eligible too (spill rows classify in place)
        assert SiteStream.wants_coded_lazy(
            dataclasses.replace(base, in_bin=False), np.float64)
        assert not SiteStream.wants_coded_lazy(
            dataclasses.replace(base, evol_model=4), np.float64)
        assert not SiteStream.wants_coded_lazy(
            dataclasses.replace(base, verbose=8), np.float64)
        monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
        assert not SiteStream.wants_coded_lazy(base, np.float64)
        monkeypatch.delenv("NGSDIST_FUSED_READ")
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "0")
        assert not SiteStream.wants_coded_lazy(base, np.float64)

    def test_runner_lazy_coded_end_to_end(self, mesh8, tmp_path,
                                          monkeypatch):
        """runner.run on a MESH under a tiny host budget routes
        --call_geno binary runs through lazy CODED rounds (single-device
        runs take the deferred CodedBinInput handle instead) and
        reproduces the full-budget file."""
        from ngsdist_jax import runner

        from ngsdist_jax.parallel.multihost import SiteStream

        S, N = 90, 5
        path = self._gp(tmp_path, S, N, seed=4)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        calls = []
        orig = SiteStream._read_codes
        monkeypatch.setattr(
            SiteStream, "_read_codes",
            lambda self, lo, hi: calls.append((lo, hi)) or orig(self, lo, hi))

        def run(tag, budget):
            if budget is None:
                monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)
            else:
                # under the S*N*2 code plane too: the EAGER fused-coded
                # gate must decline and the LAZY coded stream engage
                monkeypatch.setenv("NGSDIST_HOST_BUDGET", str(budget))
            pars = self._pars(path, S, N)
            pars.out = os.path.join(str(tmp_path), f"{tag}.dist")
            pars.validate()
            pars.finalize()
            runner.run(pars, engine="jax", mesh=mesh8)
            with open(pars.out) as fh:
                return fh.read()

        lazy = run("lazy", 400)
        assert calls, "lazy coded rounds never read codes"
        assert lazy == run("eager", None)

    def test_lazy_coded_text_spill(self, mesh8, tmp_path, monkeypatch):
        """TEXT GP (gz) under --call_geno defaults: lazy rounds classify
        the spill's stored log rows to codes (no re-normalize) —
        results identical to the staged lazy rounds, including empty
        lines (all -BIGNEG -> missing), argmax ties and literal-nan
        fields (NaN lut row)."""
        import gzip

        from ngsdist_jax.parallel.multihost import SiteStream

        S, N = 96, 4
        rng = np.random.default_rng(33)
        g = rng.dirichlet(np.ones(3), size=(S, N))
        g[9, 0] = [0.4, 0.4, 0.2]
        g[11, 1] = [0.25, 0.25, 0.25]
        lines = []
        for s in range(S):
            if s in (5, 40):
                lines.append("")  # empty line: site consumed as missing
                continue
            fields = []
            for i in range(N):
                t = [f"{v:.17g}" for v in g[s, i]]
                if s == 20 and i == 2:
                    t[1] = "nan"
                fields.extend(t)
            lines.append("\t".join(fields))
        path = os.path.join(str(tmp_path), "gp.geno.gz")
        with gzip.open(path, "wt") as fh:
            fh.write("\n".join(lines) + "\n")

        from ngsdist_jax.config import Params

        pars = Params(in_geno=path, in_bin=False, in_probs=True, n_ind=N,
                      n_sites=S, out="y", seed=3, indep_geno=True,
                      call_geno=True, pairwise_del=True, evol_model=1,
                      n_boot_rep=2, boot_block_size=4, verbose=0)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "2000")
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "100000000")

        monkeypatch.setenv("NGSDIST_FUSED_READ", "0")
        staged = SiteStream.from_reader(pars, mesh8, np.float64)
        assert staged.lazy and not staged.coded and staged.spill_norm
        want = self._mats(pars, staged, mesh8)
        staged.close()

        monkeypatch.setenv("NGSDIST_FUSED_READ", "auto")
        coded = SiteStream.from_reader(pars, mesh8, np.float64)
        assert coded.lazy and coded.coded and coded.spill_norm
        got = self._mats(pars, coded, mesh8)
        coded.close()
        assert len(want) == len(got) == 3
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        # the nan site must actually have produced NaN somewhere or the
        # NaN lane is untested
        assert any(np.isnan(a).any() for a in want)

    def test_2d_pairs_mesh_coded(self, tmp_path, monkeypatch):
        """Coded shards compose with the 2-D (sites, pairs) mesh: the
        code plane shards over 'sites' and replicates over 'pairs'
        (resident AND lazy rounds), matching the 1-D mesh bit-for-bit."""
        from ngsdist_jax.parallel import mesh as pm

        S, N = 120, 5
        path = self._gp(tmp_path, S, N, seed=6)
        pars = self._pars(path, S, N)
        monkeypatch.setenv("NGSDIST_CODED_UPLOAD", "1")
        monkeypatch.setenv("NGSDIST_DEVICE_BUDGET", "100000000")
        monkeypatch.delenv("NGSDIST_HOST_BUDGET", raising=False)

        from ngsdist_jax.parallel.multihost import SiteStream

        mesh1 = pm.make_mesh(n_devices=8)
        mesh2 = pm.make_mesh(n_devices=8, pairs=4)

        def mats(mesh):
            st = SiteStream.from_reader(pars, mesh, np.float64)
            try:
                return self._mats(pars, st, mesh), st.coded, st.lazy
            finally:
                st.close()

        want, coded1, lazy1 = mats(mesh1)
        got, coded2, lazy2 = mats(mesh2)
        assert coded1 and coded2 and not lazy1 and not lazy2
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)

        monkeypatch.setenv("NGSDIST_HOST_BUDGET", "2000")
        lazy_mats, codedl, lazyl = mats(mesh2)
        assert codedl and lazyl
        for a, b in zip(want, lazy_mats):
            np.testing.assert_array_equal(b, a)
