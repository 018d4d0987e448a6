"""Randomized CLI A/B matrix against the reference binary.

This is the checked-in, reproducible generalization of the reference's
own md5 test strategy (/root/reference/examples/test.sh:47-56): N
randomized full-config draws over the whole flag surface, each run
through BOTH binaries from the same fixture inputs —

- the reference ngsDist (tests/refharness/build/ngsDist_ref), and
- this framework's CLI, once with ``--engine exact`` (byte-identity
  required) and once with the jax engine under the CPU x64 pins
  (byte-identity required as well: docs/PARITY.md's 60/60 claim) —

plus the full fatal-error matrix (18 paths from parse_args.cpp:203-220,
ngsDist.cpp:80-144,189 and gen_func.cpp:389-400): exit status must be
255 on both sides and the ``ERROR:`` line must match word for word.

Opt-in: requires the locally built reference binary AND an explicit
``pytest -m refab`` (the suite deselects it otherwise — see conftest).
``NGSDIST_REFAB_TRIALS`` overrides the draw count (default 60).  Draws
are deterministic per trial index, so a failure reproduces with
``pytest -m refab -k trial47``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ngsdist_jax import cli

from conftest import DATA_DIR

REF_BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "refharness", "build", "ngsDist_ref")

pytestmark = [
    pytest.mark.refab,
    pytest.mark.skipif(not os.path.exists(REF_BIN),
                       reason="reference binary not built "
                              "(tests/refharness/build_ref.sh)"),
]

N_TRIALS = int(os.environ.get("NGSDIST_REFAB_TRIALS", "60"))

# (geno file, base flags, probs-space?) — the five input formats the
# fixtures cover; flags mirror the golden manifest's combos.
_INPUTS = [
    ("gt.geno.gz", [], False),
    ("gl.beagle.gz", ["--probs"], True),
    ("gl_log.geno.gz", ["--log_scale"], False),
    ("gp.bin", ["--probs"], True),
    ("gp.geno.gz", ["--probs"], True),
]


def draw_config(trial: int):
    """One reproducible full-config draw (valid flag space only — the
    fatal combinations have their own matrix below)."""
    rng = np.random.default_rng(0xAB5EED + trial)
    geno, flags, probs = _INPUTS[rng.integers(len(_INPUTS))]
    args = ["--geno", geno] + list(flags)
    lbl = rng.integers(3)
    if lbl == 1:
        args += ["--labels", "labels.txt"]
    elif lbl == 2:
        args += ["--labelsH", "labelsH.txt"]
    pos = rng.integers(3)
    if pos == 1:
        args += ["--pos", "pos.txt"]
    elif pos == 2:
        args += ["--posH", "posH.txt"]
    pairwise_del = rng.random() < 0.4
    if pairwise_del:
        args += ["--pairwise_del"]
    elif rng.random() < 0.2:
        args += ["--tot_sites", str(int(rng.integers(1200, 3000)))]
    if probs and rng.random() < 0.5:
        args += ["--call_geno"]
        if rng.random() < 0.4:
            n_thr = rng.uniform(0.0, 0.5)
            c_thr = rng.uniform(max(n_thr, 0.34), 1.0)
            args += ["--N_thresh", f"{n_thr:.3f}",
                     "--call_thresh", f"{c_thr:.3f}"]
    if rng.random() < 0.2:
        args += ["--avg_nuc_dist"]
    elif rng.random() < 0.5:
        args += ["--evol_model", str(int(rng.integers(0, 3)))]
    if rng.random() < 0.5:
        args += ["--indep_geno"]
    reps = int(rng.choice([0, 0, 1, 2, 5]))
    if reps:
        args += ["--n_boot_rep", str(reps)]
        if rng.random() < 0.7:
            args += ["--boot_block_size",
                     str(int(rng.choice([5, 10, 25, 128])))]
    args += ["--n_ind", "20", "--n_sites", "1200",
             "--n_threads", str(int(rng.choice([1, 2, 4, 10]))),
             "--seed", str(int(rng.integers(1, 1 << 20))),
             "--verbose", "0"]
    return args


def _parse_lines(b: bytes):
    """Per-line framing with numeric fields stripped: line count,
    labels, field counts — everything but the digits."""
    out = []
    for ln in b.decode().splitlines():
        f = ln.split()
        out.append((f[0] if f and not f[0].lstrip("-").replace(".", "")
                    .isdigit() else "", len(f)))
    return out


def _parse_vals(b: bytes) -> np.ndarray:
    vals = []
    for ln in b.decode().splitlines():
        f = ln.split()
        if len(f) > 2:
            vals.extend(float(v) for v in f[1:])
    return np.asarray(vals)


def run_ref(args, cwd=DATA_DIR):
    return subprocess.run([REF_BIN] + args, cwd=cwd,
                          capture_output=True, text=True)


def run_mine(args, capsys=None):
    """Drive our CLI in-process (same entry as python -m ngsdist_jax;
    in-process so 180 engine runs reuse one interpreter + jit cache)."""
    try:
        rc = cli.main(list(args))
    except SystemExit as ex:  # parse_args fatals raise SystemExit(255)
        rc = ex.code if ex.code is not None else 0
    return rc


@pytest.mark.parametrize("trial", range(N_TRIALS),
                         ids=lambda t: f"trial{t:02d}")
def test_refab_full_config(trial, tmp_path, monkeypatch):
    args = draw_config(trial)
    monkeypatch.chdir(DATA_DIR)
    ref_out = tmp_path / "ref.dist"
    r = run_ref(args + ["--out", str(ref_out)])
    assert r.returncode == 0, (
        f"reference rejected a supposedly-valid draw: {args}\n{r.stderr}")
    ref_bytes = ref_out.read_bytes()

    for engine in ("exact", "jax"):
        my_out = tmp_path / f"my_{engine}.dist"
        rc = run_mine(args + ["--out", str(my_out), "--engine", engine])
        assert rc == 0, f"{engine} engine failed on {args}"
        mine = my_out.read_bytes()
        if engine == "exact":
            # the exact engine replicates the reference's operation
            # order — byte-identity is unconditional
            assert mine == ref_bytes, (
                f"exact engine output differs from reference on {args}")
        elif mine != ref_bytes:
            # The batched x64 engine reorders f64 reductions (einsum
            # over sites; block-partial resummation for replicates),
            # shifting values by ~1 ulp (~1e-16).  %.10f absorbs that
            # except when the true value sits within ~1e-16 of a
            # 5e-11 print-rounding boundary (~1e-6 probability per
            # value) — a 300-trial soak surfaced one such digit
            # (round 5, trial 222).  Accept ONLY that class: identical
            # framing/labels and every value within one final-digit
            # step.
            assert _parse_lines(mine) == _parse_lines(ref_bytes), (
                f"jax engine framing/labels differ on {args}")
            a = _parse_vals(mine)
            b = _parse_vals(ref_bytes)
            both_nan = np.isnan(a) & np.isnan(b)
            assert not (np.isnan(a) ^ np.isnan(b)).any(), (
                f"jax engine NaN placement differs on {args}")
            d = np.abs(a[~both_nan] - b[~both_nan])
            assert d.size == 0 or d.max() <= 1.0000001e-10, (
                f"jax engine differs beyond a print-boundary ulp on "
                f"{args} (max {d.max()})")


# The fatal-error matrix: every distinct abort the reference can hit
# from the CLI surface.  BASE is a valid config; each case perturbs it.
BASE = ["--geno", "gl.beagle.gz", "--probs", "--n_ind", "20",
        "--n_sites", "1200", "--verbose", "0"]


def _without(args, flag, nargs=2):
    i = args.index(flag)
    return args[:i] + args[i + nargs:]


ERROR_CASES = {
    "no_geno": _without(BASE, "--geno") + ["--out", "{OUT}"],
    "no_n_ind": _without(BASE, "--n_ind") + ["--out", "{OUT}"],
    "no_n_sites": _without(BASE, "--n_sites") + ["--out", "{OUT}"],
    "no_out": BASE,
    "tot_sites_pairwise_del": BASE + ["--tot_sites", "1500",
                                      "--pairwise_del", "--out", "{OUT}"],
    "call_geno_no_probs": ["--geno", "gt.geno.gz", "--call_geno",
                           "--n_ind", "20", "--n_sites", "1200",
                           "--verbose", "0", "--out", "{OUT}"],
    "bad_evol_model": BASE + ["--evol_model", "7", "--out", "{OUT}"],
    "model_needs_pos": BASE + ["--evol_model", "3", "--out", "{OUT}"],
    "zero_threads": BASE + ["--n_threads", "0", "--out", "{OUT}"],
    "geno_file_missing": _without(BASE, "--geno") + [
        "--geno", "no_such_file.geno.gz", "--out", "{OUT}"],
    "bin_size_mismatch": _without(BASE, "--geno") + [
        "--geno", "{TRUNC}", "--out", "{OUT}"],
    "labels_missing": BASE + ["--labels", "no_such.labels", "--out", "{OUT}"],
    "pos_missing": BASE + ["--pos", "no_such.pos", "--out", "{OUT}"],
    "out_unwritable": BASE + ["--out", "/nonexistent_dir_xyzzy/o.dist"],
    "k80_unsupported": BASE + ["--evol_model", "3", "--pos", "pos.txt",
                               "--out", "{OUT}"],
    "f81_unsupported": BASE + ["--evol_model", "4", "--pos", "pos.txt",
                               "--out", "{OUT}"],
    "hky85_unsupported": BASE + ["--evol_model", "5", "--pos", "pos.txt",
                                 "--out", "{OUT}"],
    "tn93_unsupported": BASE + ["--evol_model", "6", "--pos", "pos.txt",
                                "--out", "{OUT}"],
}
assert len(ERROR_CASES) == 18


def _error_line(stderr: str) -> str:
    for ln in stderr.splitlines():
        if ln.startswith("ERROR:"):
            return ln
    return f"<no ERROR line in: {stderr[-300:]!r}>"


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_refab_error_path(case, tmp_path, monkeypatch, capsys):
    args = list(ERROR_CASES[case])
    trunc = tmp_path / "short.bin"
    trunc.write_bytes(b"\0" * 1000)  # wrong size for 20 x 1200 doubles
    args = [a.replace("{OUT}", str(tmp_path / "o.dist"))
             .replace("{TRUNC}", str(trunc)) for a in args]
    monkeypatch.chdir(DATA_DIR)
    r = run_ref(args)
    assert r.returncode == 255, f"{case}: reference did not abort\n{r.stderr}"
    capsys.readouterr()
    if case.endswith("_unsupported"):
        # Models 3-6 are a documented beyond-reference extension of the
        # jax engine (core/submodels.py); the reference's abort is
        # reproduced by the exact engine only.
        args += ["--engine", "exact"]
    rc = run_mine(args)
    err = capsys.readouterr().err
    assert rc == 255, f"{case}: our CLI returned {rc}, want 255"
    assert _error_line(err) == _error_line(r.stderr), (
        f"{case}: ERROR line differs")
