"""Unit tests for host-side components: RNG, readers, writer formatting,
preprocessing, config implication rules — the unit layer the reference
lacks (SURVEY.md §4)."""

import gzip
import io
import math
import os
import struct

import numpy as np
import pytest

from ngsdist_jax import cli
from ngsdist_jax.config import Params, NgsDistError, default_score_matrix
from ngsdist_jax.core import bootstrap as bt
from ngsdist_jax.core import models
from ngsdist_jax.core.preprocess import call_geno_inplace, preprocess
from ngsdist_jax.io import readers, writers
from ngsdist_jax.utils import native as nat
from ngsdist_jax.utils.rng import TausRng, boot_block_indices


class TestTausRng:
    def test_matches_native(self):
        lib = nat.get_lib()
        for seed in (0, 1, 12345, 2**32 - 1):
            out = np.empty(64)
            lib.nd_taus_uniforms(seed & 0xFFFFFFFF, 64, nat.as_double_ptr(out))
            r = TausRng(seed)
            py = np.array([r.uniform() for _ in range(64)])
            assert (out == py).all()

    def test_block_tables_match(self):
        lib = nat.get_lib()
        tbl_n = np.empty((5, 13), dtype=np.uint64)
        lib.nd_boot_block_indices(99, 5, 13, nat.as_u64_ptr(tbl_n))
        assert (tbl_n == boot_block_indices(99, 5, 13)).all()
        assert tbl_n.max() < 13

    def test_seed_zero_equals_one(self):
        assert TausRng(0).uniform() == TausRng(1).uniform()

    def test_gsl_known_answer(self):
        """Known-answer test against the GNU Scientific Library's own
        published test vector for gsl_rng_taus (GSL rng/test.c:
        ``rng_test (gsl_rng_taus, 1, 10000, 2733957125UL)``) — the
        10000th 32-bit output after seeding with 1.  This pins the taus
        stream to real GSL independently of the refharness gslshim, so
        golden bootstrap fixtures generated with the shim-built
        reference binary are not circular (the reference seeds
        gsl_rng_taus at /root/reference/ngsDist.cpp:179-180)."""
        r = TausRng(1)
        v = 0
        for _ in range(10000):
            v = r.next_u32()
        assert v == 2733957125
        # Same stream through the native C implementation (taus.h),
        # checked via the uniform scaling u32 / 2^32.
        lib = nat.get_lib()
        out = np.empty(10000)
        lib.nd_taus_uniforms(1, 10000, nat.as_double_ptr(out))
        assert out[-1] == 2733957125 / 4294967296.0


class TestScoreMatrix:
    def test_default(self):
        s = default_score_matrix()
        assert s[0, 0] == s[1, 1] == s[2, 2] == 0
        assert s[0, 1] == s[1, 0] == s[1, 2] == s[2, 1] == 0.5
        assert s[0, 2] == s[2, 0] == 1

    def test_avg_nuc_dist(self):
        assert default_score_matrix(avg_nuc_dist=True)[1, 1] == 0.5


class TestWriterFormat:
    def test_c_printf_compat(self):
        assert writers.fmt_c_double(0.0) == "0.0000000000"
        assert writers.fmt_c_double(-0.0) == "-0.0000000000"
        assert writers.fmt_c_double(0.123456789049) == "0.1234567890"
        assert writers.fmt_c_double(float("nan")) == "nan"
        assert writers.fmt_c_double(-float("nan")) == "-nan"
        assert writers.fmt_c_double(float("inf")) == "inf"
        assert writers.fmt_c_double(float("-inf")) == "-inf"

    def test_matrix_framing(self):
        buf = io.StringIO()
        writers.write_dist_matrix(buf, ["a", "b"], np.array([[0.0, 1.5], [1.5, 0.0]]))
        assert buf.getvalue() == (
            "\n2\n"
            "a\t0.0000000000\t1.5000000000\n"
            "b\t1.5000000000\t0.0000000000\n"
        )


class TestConfig:
    def test_log_scale_implies_probs(self):
        pars, _ = cli.parse_args(["--log_scale", "--geno", "x.gz"])
        assert pars.in_probs and pars.in_logscale

    def test_thresholds_imply_call_geno(self):
        pars, _ = cli.parse_args(["--N_thresh", "0.2", "--geno", "x.gz"])
        assert pars.call_geno

    def test_prefix_matching(self):
        pars, _ = cli.parse_args(["--n_boot", "7", "--geno", "x"])
        assert pars.n_boot_rep == 7

    def test_atof_c_semantics(self):
        """cli._atof is full C atof: longest strtod prefix incl. hex
        floats, inf/infinity and nan, 0.0 when nothing parses
        (parse_args.cpp atof on N_thresh/call_thresh; `--N_thresh inf`
        A/B-verified: echo 'N_thresh: inf' + the same call_geno
        ordering fatal as the reference)."""
        at = cli._atof
        assert at("inf") == float("inf")
        assert at("-Infinity") == float("-inf")
        assert at("  +inf junk") == float("inf")
        assert np.isnan(at("nan")) and np.isnan(at("NaN(chars)"))
        assert at("0x1p-2") == 0.25
        assert at("0x1.8p3") == 12.0
        assert at("-0x10") == -16.0
        assert at("0xG") == 0.0  # 0x with no hex digits -> "0"
        assert at("1e") == 1.0   # dangling exponent -> "1"
        assert at("3.5e2x") == 350.0
        assert at("x12") == 0.0
        assert at("") == 0.0

    def test_atof_fuzz_vs_libc(self):
        """Property fuzz: cli._atof must equal the C library's actual
        atof on random strings drawn from the numeric alphabet
        (decimal/hex/exponent/inf/nan fragments)."""
        import ctypes
        import ctypes.util

        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        libc.atof.restype = ctypes.c_double
        libc.atof.argtypes = [ctypes.c_char_p]

        rng = np.random.default_rng(99)
        alphabet = list("0123456789.xXpPeE+-infinityNA() \t")
        for _ in range(2000):
            n = int(rng.integers(0, 12))
            s = "".join(rng.choice(alphabet) for _ in range(n))
            want = libc.atof(s.encode())
            got = cli._atof(s)
            if np.isnan(want):
                assert np.isnan(got), repr(s)
            else:
                assert got == want, (repr(s), got, want)

    def test_reference_options_outrank_extensions(self):
        """A script written for the reference CLI must resolve
        identically regardless of the framework's extra flags: --pair
        is pairwise_del (not --pairs), -x is the n_threads short option
        (not --x64), --e is evol_model (not --engine), --t is
        tot_sites (not --trace_dir/--throughput)."""
        pars, extras = cli.parse_args(
            ["--pair", "--geno", "x", "-x", "4", "--e", "2", "--t", "99"])
        assert pars.pairwise_del and pars.n_threads == 4
        assert pars.evol_model == 2 and pars.tot_sites == 99
        assert extras.get("engine") == "auto" and not extras.get("x64")
        # extensions still reachable by exact name or unique prefix
        pars, extras = cli.parse_args(
            ["--geno", "x", "--pairs", "2", "--x64", "--plat", "cpu"])
        assert extras["pairs"] == "2" and extras["x64"] is True
        assert extras["platform"] == "cpu" and not pars.pairwise_del

    def test_single_dash_long(self):
        pars, _ = cli.parse_args(["-geno", "f.gz", "-n_ind", "5"])
        assert pars.in_geno == "f.gz" and pars.n_ind == 5

    def test_ambiguous_prefix_is_fatal_for_double_dash(self):
        """getopt_long_only: '--n' is ambiguous among the reference's
        n_* options (single getopt line, exit 255, no ERROR block);
        '-n' (single dash) falls back to the n_ind short option."""
        with pytest.raises(SystemExit) as ei:
            cli.parse_args(["--n", "3", "--geno", "x"])
        assert ei.value.code == 255
        pars, _ = cli.parse_args(["-n", "3", "--geno", "x"])
        assert pars.n_ind == 3

    def test_positionals_ignored_and_double_dash_ends_options(self):
        """getopt permutes non-option arguments to the end and the
        reference never examines them; '--' ends option parsing."""
        pars, _ = cli.parse_args(["--geno", "x", "stray", "--n_ind", "5"])
        assert pars.in_geno == "x" and pars.n_ind == 5
        pars, _ = cli.parse_args(["--n_ind", "5", "--", "--n_sites", "9"])
        assert pars.n_ind == 5 and pars.n_sites == 0

    def test_required_argument_consumes_next_token(self):
        """getopt required_argument takes the next argv verbatim, even
        when it looks like an option (C atol then yields 0)."""
        pars, _ = cli.parse_args(["--n_ind", "--out", "f"])
        assert pars.n_ind == 0 and pars.out is None  # f was positional

    def test_degenerate_bootstrap_args_are_clean_fatals(self):
        """--n_boot_rep -1 loops effectively forever in the reference
        (uint64 wraparound of the replicate bound) and
        --boot_block_size 0 hits n_sites % 0: both are clean exit-255
        fatals here (documented beyond-reference guards)."""
        from ngsdist_jax.config import NgsDistError, Params

        with pytest.raises(NgsDistError, match="cannot be negative"):
            Params(in_geno="x", n_ind=2, n_sites=5, out="y",
                   n_boot_rep=-1).validate()
        with pytest.raises(NgsDistError, match="block size"):
            Params(in_geno="x", n_ind=2, n_sites=5, out="y",
                   boot_block_size=0, n_boot_rep=1).validate()

    def test_validation_order(self):
        with pytest.raises(NgsDistError, match="--geno"):
            Params().validate()
        with pytest.raises(NgsDistError, match="--n_ind"):
            Params(in_geno="x").validate()
        with pytest.raises(NgsDistError, match="--tot_sites"):
            Params(in_geno="x", n_ind=2, n_sites=2, tot_sites=5, pairwise_del=True,
                   out="o").validate()
        with pytest.raises(NgsDistError, match="call genotypes"):
            Params(in_geno="x", n_ind=2, n_sites=2, call_geno=True, out="o").validate()
        with pytest.raises(NgsDistError, match="position information"):
            Params(in_geno="x", n_ind=2, n_sites=2, evol_model=3, in_probs=True,
                   out="o").validate()

    def test_genotype_input_forces_indep(self, tmp_path):
        f = tmp_path / "g.geno.gz"
        f.write_bytes(gzip.compress(b"0\t1\n"))
        pars = Params(in_geno=str(f), n_ind=2, n_sites=1, out="o")
        pars.validate()
        pars.finalize()
        assert pars.indep_geno and not pars.in_bin

    def test_binary_sniff_and_size_check(self, tmp_path):
        f = tmp_path / "g.bin"
        f.write_bytes(b"\0" * (8 * 2 * 3 * 4))  # 2 ind x 4 sites x 3 geno
        pars = Params(in_geno=str(f), n_ind=2, n_sites=4, in_probs=True, out="o")
        pars.finalize()
        assert pars.in_bin and pars.in_probs
        pars2 = Params(in_geno=str(f), n_ind=2, n_sites=5, in_probs=True, out="o")
        with pytest.raises(NgsDistError, match="corrupt"):
            pars2.finalize()


class TestModels:
    def test_unsupported_model_messages(self):
        for model, name in [(3, "K80"), (4, "F81"), (5, "HKY85"), (6, "TN93")]:
            with pytest.raises(NgsDistError, match=f"{name} model not yet supported"):
                models.check_model_supported(model)

    def test_transforms(self):
        d = np.array([0.0, 0.1, 0.3])
        assert np.allclose(models.apply_evol_model(d, 0), d)
        assert np.allclose(models.apply_evol_model(d, 1), -np.log(1 - d))
        assert np.allclose(
            models.apply_evol_model(d, 2), -np.log(1 - d * 4 / 3) * 3 / 4
        )


class TestCallGeno:
    def test_default_thresholds_hard_call(self):
        g = np.log(np.array([[[0.7, 0.2, 0.1]]]))
        call_geno_inplace(g, 0.0, 0.0)
        assert g[0, 0, 0] == 0.0 and g[0, 0, 1] == -1e15

    def test_missing_stays_uniform(self):
        g = np.full((1, 1, 3), np.log(1 / 3))
        call_geno_inplace(g, 0.0, 0.0)
        assert np.allclose(np.exp(g), 1 / 3)

    def test_n_thresh_sets_missing(self):
        g = np.log(np.array([[[0.4, 0.35, 0.25]]]))
        call_geno_inplace(g, 0.5, 0.9)
        assert np.allclose(np.exp(g), 1 / 3)

    def test_mid_band_left_as_probs(self):
        tri = np.array([[[0.6, 0.3, 0.1]]])
        g = np.log(tri.copy())
        call_geno_inplace(g, 0.3, 0.9)
        assert np.allclose(np.exp(g), tri)

    def test_invalid_thresholds(self):
        g = np.zeros((1, 1, 3))
        with pytest.raises(NgsDistError):
            call_geno_inplace(g, 0.9, 0.3)

    def test_python_matches_native(self):
        rng = np.random.default_rng(5)
        tri = rng.dirichlet([1, 1, 1], size=200).reshape(200, 1, 3)
        tri[::17] = 1 / 3
        g1 = np.log(tri.copy())
        g2 = np.log(tri.copy())
        call_geno_inplace(g1, 0.35, 0.9, native=True)
        call_geno_inplace(g2, 0.35, 0.9, native=False)
        assert np.allclose(g1, g2)


class TestReaders:
    def _gz(self, tmp_path, text, name="x.geno.gz"):
        p = tmp_path / name
        p.write_bytes(gzip.compress(text.encode()))
        return str(p)

    def test_native_matches_python_on_fixtures(self, data_dir):
        cases = [
            ("gt.geno.gz", False, False, False),
            ("gl.beagle.gz", False, True, False),
            ("gl_log.geno.gz", False, True, True),
            ("gp.geno.gz", False, True, False),
            ("gp.bin", True, True, False),
        ]
        for fname, in_bin, in_probs, in_log in cases:
            path = os.path.join(data_dir, fname)
            a = readers.read_geno(path, in_bin, in_probs, in_log, 20, 1200, native=True)
            b = readers.read_geno(path, in_bin, in_probs, in_log, 20, 1200, native=False)
            assert np.allclose(a, b, rtol=0, atol=1e-13), fname

    def test_genotype_onehot_and_missing(self, tmp_path):
        path = self._gz(tmp_path, "0\t2\n-1\t1\n")
        g = readers.read_geno(path, False, False, False, 2, 2)
        assert g[0, 0, 0] == 0.0 and g[0, 1, 2] == 0.0
        assert np.allclose(g[1, 0], np.log(1 / 3))
        assert g[1, 1, 1] == 0.0

    def test_genotype_out_of_range(self, tmp_path):
        path = self._gz(tmp_path, "0\t3\n")
        with pytest.raises(NgsDistError, match="coded as"):
            readers.read_geno(path, False, False, False, 2, 1)

    def test_last_columns_rule(self, tmp_path):
        # numeric leading column must shift the window to the LAST n fields
        path = self._gz(tmp_path, "999\t0\t1\n")
        g = readers.read_geno(path, False, False, False, 2, 1)
        assert g[0, 0, 0] == 0.0 and g[0, 1, 1] == 0.0

    def test_header_skipped(self, tmp_path, capfd):
        path = self._gz(tmp_path, "marker\tallele\n0\t1\n")
        g = readers.read_geno(path, False, False, False, 2, 1)
        assert g[0, 0, 0] == 0.0
        assert "Header found" in capfd.readouterr().err

    def test_empty_line_consumes_site_as_missing(self, tmp_path):
        path = self._gz(tmp_path, "0\t1\n\n1\t1\n")
        g = readers.read_geno(path, False, False, False, 2, 3)
        assert (g[1] == -1e15).all()

    def test_premature_eof(self, tmp_path):
        path = self._gz(tmp_path, "0\t1\n")
        with pytest.raises(NgsDistError, match="premature EOF"):
            readers.read_geno(path, False, False, False, 2, 5)

    def test_not_at_eof(self, tmp_path):
        path = self._gz(tmp_path, "0\t1\n1\t1\n")
        with pytest.raises(NgsDistError, match="not at EOF"):
            readers.read_geno(path, False, False, False, 2, 1)

    def test_reader_error_carries_libm_errno(self, tmp_path):
        """The reference's fatal reader messages end in perror, so their
        strerror suffix is ERANGE whenever an earlier triple's
        log-sum-exp underflowed (any one-hot genotype does).  The
        native reader aggregates its parse workers' thread-local errno
        into NgsDistError.err."""
        import errno as _errno

        path = self._gz(tmp_path, "0\t1\n")
        with pytest.raises(NgsDistError) as ei:
            readers.read_geno(path, False, False, False, 2, 5)
        assert ei.value.err == _errno.ERANGE
        # probability input with moderate spreads: no underflow -> 0
        path = self._gz(tmp_path, "0.2\t0.3\t0.5\t0.1\t0.1\t0.8\n")
        with pytest.raises(NgsDistError) as ei:
            readers.read_geno(path, False, True, False, 2, 5)
        assert ei.value.err == 0

    def test_mid_file_header_warning(self, tmp_path, capfd):
        """A zero-numeric-field line past the first prints the header
        warning, echoes the line with the reference's literal "/n"
        (read_data.cpp:68), and does not consume a site."""
        path = self._gz(tmp_path, "0\t1\nmarker\tallele\n1\t1\n")
        g = readers.read_geno(path, False, False, False, 2, 2)
        assert g[1, 0, 1] == 0.0
        err = capfd.readouterr().err
        assert "Header found" in err and "not on first line" in err
        assert "marker\tallele/n" in err

    def test_errno_not_polluted_by_unconsumed_lines(self, tmp_path):
        """The slab workers parse ahead, but the errno reported with a
        fatal must reflect only the lines the reference would have
        parsed: a one-hot line AFTER the fatal short line (whose
        log-sum-exp would set ERANGE) must not leak into err."""
        path = self._gz(
            tmp_path,
            "0.2 0.3 0.5 0.1 0.1 0.8\n0.5\n1 0 0 1 0 0\n",
        )
        with pytest.raises(NgsDistError, match="Less fields") as ei:
            readers.read_geno(path, False, True, False, 2, 3)
        assert ei.value.err == 0
        # ... and a trailing one-hot line past the last site (not-at-EOF
        # error path) is equally never parsed by the reference
        path = self._gz(
            tmp_path, "0.2 0.3 0.5 0.1 0.1 0.8\n1 0 0 1 0 0\n"
        )
        with pytest.raises(NgsDistError, match="not at EOF") as ei:
            readers.read_geno(path, False, True, False, 2, 1)
        assert ei.value.err == 0

    def test_binary_nan_outranks_premature_eof(self, tmp_path):
        """The reference NaN-checks each triple as it reads, so a NaN
        among completed triples errors before a later short read
        (read_data.cpp:29-47) — native and python binary readers."""
        vals = np.array([0.2, 0.3, 0.5, -0.1, 0.5, 0.6, 0.3, 0.3, 0.4])
        p = tmp_path / "nan_eof.bin"
        p.write_bytes(vals.tobytes())
        for native in (True, False):
            with pytest.raises(NgsDistError, match="NaN found"):
                readers.read_geno(str(p), True, True, False, 2, 2,
                                  native=native)

    def test_binary_eof_triple_granularity(self, tmp_path):
        """The reference's read/normalize/NaN-check unit is the
        individual TRIPLE, not the site (read_data.cpp:29-45): a NaN in
        a COMPLETE triple of a partially-read final site still fatals
        "NaN found!" (A/B-verified vs the reference binary), while a
        clean short read — including a torn mid-triple read — fatals
        premature EOF."""
        # 1 complete site + 1 complete triple of site 1; the NaN sits in
        # that complete triple of the INCOMPLETE site
        vals = np.concatenate([np.full(3 * 3, 1 / 3), [np.nan, 0.5, 0.5]])
        p = tmp_path / "g.bin"
        p.write_bytes(vals.tobytes())
        for native in (True, False):
            with pytest.raises(NgsDistError, match="NaN found"):
                readers.read_geno(str(p), True, True, False, 3, 2,
                                  native=native)
        # same shape, torn mid-triple with no NaN in complete triples:
        # the partial triple is never normalized -> premature EOF
        vals2 = np.concatenate([np.full(3 * 3, 1 / 3), [0.5, 0.5]])
        p2 = tmp_path / "g2.bin"
        p2.write_bytes(vals2.tobytes())
        for native in (True, False):
            with pytest.raises(NgsDistError, match="premature EOF"):
                readers.read_geno(str(p2), True, True, False, 3, 2,
                                  native=native)

    def test_binary_roundtrip_normalizes(self, tmp_path):
        vals = [0.2, 0.3, 0.5, 0.1, 0.1, 0.8]
        p = tmp_path / "b.bin"
        p.write_bytes(struct.pack("<6d", *vals))
        g = readers.read_geno(str(p), True, True, False, 2, 1)
        assert np.allclose(np.exp(g[0, 0]), [0.2, 0.3, 0.5])

    def test_labels(self, tmp_path):
        p = tmp_path / "l.txt"
        p.write_text("# c\nA\tjunk\n\nB\nC\n")
        assert readers.read_labels(str(p), False, 3) == ["A", "B", "C"]
        with pytest.raises(NgsDistError):
            readers.read_labels(str(p), False, 4)

    def test_labels_header(self, tmp_path):
        p = tmp_path / "l.txt"
        p.write_text("name\nA\nB\n")
        assert readers.read_labels(str(p), True, 2) == ["A", "B"]

    def test_final_unterminated_line_dropped(self, tmp_path):
        """read_file checks gzeof BEFORE processing the line it just
        read (gen_func.cpp:253-255): a final line with no newline is
        silently dropped — A/B-verified: the reference then fails with
        'invalid LABELS file!' on such a labels file."""
        p = tmp_path / "l.txt"
        p.write_text("A\nB\nC")  # C unterminated -> dropped
        assert readers.read_file_lines(str(p)) == ["A", "B"]
        with pytest.raises(NgsDistError, match="invalid LABELS file!"):
            readers.read_labels(str(p), False, 3)

    def test_overlong_line_chunks_at_buff_len(self, tmp_path):
        """gzgets(buf, BUFF_LEN) reads at most 499999 chars
        (gen_func.cpp:251): an over-long line becomes multiple 'lines',
        one per chunk — A/B-verified byte-identical phylip output on a
        750000-char label line."""
        p = tmp_path / "l.txt"
        big = "A" * 750000
        p.write_text(big + "\nB\n")
        lines = readers.read_file_lines(str(p))
        assert lines == [big[:499999], big[499999:], "B"]

    def test_pos(self, tmp_path):
        p = tmp_path / "p.txt"
        p.write_text("chr1\t1\t0\t1\nchr1\t5\t0\t2\n")
        rows = readers.read_pos(str(p), False, 2)
        assert rows[0][0] == "chr1" and rows[1][1] == "5"
        with pytest.raises(NgsDistError):
            readers.read_pos(str(p), False, 3)


class TestBootstrap:
    def test_truncation(self):
        assert bt.truncated_n_sites(1200, 7) == 1197
        assert bt.truncated_n_sites(1200, 10) == 1200

    def test_site_maps_shape(self):
        n_trunc, maps = bt.site_maps(4242, 3, 1200, 7)
        assert n_trunc == 1197 and len(maps) == 3
        assert all(len(m) == 1197 for m in maps)
        assert all(m.max() < 1197 for m in maps)

    def test_multiplicity(self):
        tbl = np.array([[0, 0, 2]], dtype=np.uint64)
        m = bt.block_multiplicity(tbl, 3)
        assert (m == [[2, 0, 1]]).all()


class TestPreprocess:
    def test_preprocess_pipeline(self):
        g = np.log(np.array([[[0.7, 0.2, 0.1]]]))
        out = preprocess(g, call_geno=True, N_thresh=0.0, call_thresh=0.0)
        assert np.allclose(out, [[[1.0, 0.0, 0.0]]])


def test_two_column_pos_verbose4_dump_is_graceful(tmp_path, capfd):
    """The reference SEGFAULTS dumping a 2-column POS file at
    verbose>=4 (prints 4 columns unconditionally, ngsDist.cpp:146-148);
    here the row echoes padded with empty fields (documented
    divergence, docs/PARITY.md)."""
    import gzip

    from ngsdist_jax import runner
    from ngsdist_jax.config import Params

    rng = np.random.default_rng(0)
    gp = rng.dirichlet(np.ones(3), size=(6, 3))
    geno = tmp_path / "gp.geno.gz"
    with gzip.open(geno, "wt") as fh:
        for s in range(6):
            fh.write("\t".join(f"{x:.6f}" for x in gp[s].reshape(-1)) + "\n")
    pos = tmp_path / "pos.txt"
    pos.write_text("".join(f"chr1\t{i+1}\n" for i in range(6)))
    pars = Params(in_geno=str(geno), in_probs=True, n_ind=3, n_sites=6,
                  in_pos=str(pos), verbose=4, seed=1,
                  out=str(tmp_path / "o.dist"))
    pars.validate(); pars.finalize()
    mats = runner.run(pars, engine="exact")
    assert len(mats) == 1
    assert "chr1\t1\t\t" in capfd.readouterr().err


class TestStreamChunkPlanner:
    """Pipeline-depth chunk sizing (distance._stream_chunk_sites and the
    SiteStream round planner): streamed chunks target >= 16 rounds so
    the first chunk's unoverlapped read stays a small fraction of the
    stream (round-4 1M e2e: 2 budget-sized chunks exposed 90 s of a
    281 s run), floored at 16k sites, with the device budget as the
    hard upper bound."""

    def test_headline_shape_gets_depth(self):
        from ngsdist_jax.core import distance as dist

        # 1024 ind x 1M sites f32 against the default 12 GiB/3 budget:
        # barely over budget -> old sizing gave 2 chunks, now 16.
        S, N, itemsize = 1 << 20, 1024, 4
        budget = (12 << 30) // 3
        assert S * N * 3 * itemsize > budget
        chunk = dist._stream_chunk_sites(S, N, itemsize, budget)
        assert chunk == S // dist.STREAM_MIN_CHUNKS
        assert -(-S // chunk) >= dist.STREAM_MIN_CHUNKS

    def test_budget_remains_upper_bound(self):
        from ngsdist_jax.core import distance as dist

        # tiny forced budgets (test fixtures) keep their exact old size
        S, N, itemsize = 1200, 20, 8
        budget = dist._WORKING_SET_FACTOR * 16 * N * 3 * 8 \
            * dist.PREFETCH_KEEP_DEN // dist.PREFETCH_KEEP_NUM \
            // dist._WORKING_SET_FACTOR
        chunk = dist._stream_chunk_sites(S, N, itemsize, budget)
        cap = (budget * dist.PREFETCH_KEEP_NUM
               // dist.PREFETCH_KEEP_DEN) // (N * 3 * itemsize)
        assert chunk == cap  # depth floor never exceeds the budget cap

    def test_small_streams_keep_min_chunk(self):
        from ngsdist_jax.core import distance as dist

        # S/16 below the floor: the 16k minimum wins (fetch overhead)
        chunk = dist._stream_chunk_sites(100_000, 64, 4, 1 << 62)
        assert chunk == dist.STREAM_MIN_CHUNK_SITES

    def test_sitestream_plan_depth_and_alignment(self):
        from ngsdist_jax.config import Params
        from ngsdist_jax.core import distance as dist
        from ngsdist_jax.parallel import make_mesh
        from ngsdist_jax.parallel.multihost import SiteStream

        mesh = make_mesh(n_devices=8)
        pars = Params(in_geno="x", n_ind=64, n_sites=1 << 20, out="o",
                      n_boot_rep=2, boot_block_size=96, indep_geno=True)
        old = os.environ.get("NGSDIST_DEVICE_BUDGET")
        os.environ["NGSDIST_DEVICE_BUDGET"] = str(
            pars.n_sites * pars.n_ind * 3 * 4 // 8)  # force streaming
        try:
            s_loc, chunk = SiteStream._plan(pars, mesh, np.float32)
        finally:
            if old is None:
                del os.environ["NGSDIST_DEVICE_BUDGET"]
            else:
                os.environ["NGSDIST_DEVICE_BUDGET"] = old
        # s_loc = round_up(2^20/8, 96) = 131136; the old budget-only
        # sizing gave chunk 32736 (4 rounds + remainder); the depth
        # target is round_up(max(s_loc/16, 16384), 96) = 16416 -> 8
        # aligned rounds, still under the budget cap.
        assert s_loc == 131136
        assert chunk == 16416
        assert chunk % pars.boot_block_size == 0  # alignment kept


class TestPipelinedChunks:
    """Two-stage streamed staging (distance._pipelined_chunks): the
    fused read/pack of chunk k+1 must run CONCURRENTLY with the device
    send of chunk k — a single staging thread serializes parse time
    against a synchronous link copy (round-4 1M e2e: 81 s of read time
    exposed above the 183 s link floor)."""

    def test_order_and_completeness(self):
        from ngsdist_jax.core.distance import _pipelined_chunks

        ranges = [(i, i + 1) for i in range(7)]
        out = list(_pipelined_chunks(ranges, lambda r: r, lambda r: r[0]))
        assert out == list(range(7))

    def test_empty(self):
        from ngsdist_jax.core.distance import _pipelined_chunks

        assert list(_pipelined_chunks([], lambda r: r, lambda r: r)) == []

    def test_read_overlaps_send(self):
        import threading

        from ngsdist_jax.core.distance import _pipelined_chunks

        # send(k) BLOCKS until read(k+1) has started: if the stages
        # shared a thread this deadlocks (the 5 s join below fails);
        # with two stages it completes immediately.
        read_started = [threading.Event() for _ in range(4)]

        def read_fn(rng):
            read_started[rng[0]].set()
            return rng[0]

        def send_fn(k):
            if k + 1 < len(read_started):
                assert read_started[k + 1].wait(timeout=5.0), \
                    "read of chunk k+1 never started while send k blocked"
            return k

        done: list = []
        t = threading.Thread(
            target=lambda: done.extend(_pipelined_chunks(
                [(i, i + 1) for i in range(4)], read_fn, send_fn)))
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive(), "pipeline deadlocked: stages share a thread"
        assert done == [0, 1, 2, 3]

    def test_read_error_propagates(self):
        from ngsdist_jax.core.distance import _pipelined_chunks

        def read_fn(rng):
            if rng[0] == 2:
                raise ValueError("NaN found in site block")
            return rng

        with pytest.raises(ValueError, match="NaN"):
            list(_pipelined_chunks([(i, i + 1) for i in range(4)],
                                   read_fn, lambda r: r))
