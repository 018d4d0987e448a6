"""chip_smoke.py at tiny sizes on the CPU: its data generator, the
subset-parity helper, the phases' CLI runs, the last-line format, and
its refusal to run without a GPU or without the repository."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from ngsdist_jax.io import readers

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = cs.Sizes(n_ind=12, em_sites=40, indep_sites=64, kernel_sites=16,
                subset=6, boot_reps=2, boot_block=8)


@pytest.fixture
def quiet_cli(monkeypatch):
    """In-process CLI runs without installing signal handlers."""
    from ngsdist_jax.utils import signals

    monkeypatch.setattr(signals, "arm", lambda: None)


def test_make_probs_shape_and_missing_share():
    P = cs.make_probs(np.random.default_rng(0), 400, 50, missing=0.1)
    assert P.shape == (400, 50, 3)
    np.testing.assert_allclose(P.sum(-1), 1.0, rtol=1e-12)
    miss = np.all(np.abs(P - 1 / 3) < 1e-12, axis=-1)
    assert 0.07 < miss.mean() < 0.13


def test_generated_inputs_read_back(tmp_path):
    """The gz Beagle text reads back (normalized) to the generated
    probabilities within its 4-decimal quantization, the binary file
    exactly, and each cut holds the leading individuals."""
    paths = cs.make_inputs(str(tmp_path), TINY)
    P_em = cs.make_probs(np.random.default_rng(TINY.seed), TINY.em_sites,
                         TINY.n_ind)
    got = np.exp(readers.read_geno(paths["em"], False, True, False,
                                   TINY.n_ind, TINY.em_sites))
    np.testing.assert_allclose(got, P_em, atol=2e-4)
    sub = np.exp(readers.read_geno(paths["em_sub"], False, True, False,
                                   TINY.subset, TINY.em_sites))
    np.testing.assert_array_equal(sub, got[:, :TINY.subset])
    B = np.fromfile(paths["bin"]).reshape(TINY.indep_sites, TINY.n_ind, 3)
    Bs = np.fromfile(paths["bin_sub"]).reshape(TINY.indep_sites,
                                                TINY.subset, 3)
    np.testing.assert_array_equal(Bs, B[:, :TINY.subset])
    np.testing.assert_allclose(B.sum(-1), 1.0, rtol=1e-12)


def test_subset_parity_helper():
    rng = np.random.default_rng(1)
    full = [rng.random((8, 8)) for _ in range(2)]
    sub = [m[:5, :5].copy() for m in full]
    assert cs.subset_parity(full, sub) == 0.0
    sub[1][2, 3] += 1e-3
    assert abs(cs.subset_parity(full, sub) - 1e-3) < 1e-12
    sub[1][2, 3] = np.nan
    with pytest.raises(AssertionError, match="NaN positions"):
        cs.subset_parity(full, sub)
    with pytest.raises(AssertionError, match="matrices"):
        cs.subset_parity(full, sub[:1])


def test_read_dist_round_trip(tmp_path):
    from ngsdist_jax.io import writers

    mats = [np.array([[0.0, 0.25], [0.25, 0.0]]),
            np.array([[0.0, np.nan], [np.nan, 0.0]])]
    path = tmp_path / "m.dist"
    with open(path, "w") as f:
        for m in mats:
            writers.write_dist_matrix(f, ["a", "b"], m)
    got = cs.read_dist(str(path))
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], mats[0])
    assert np.isnan(got[1][0, 1]) and got[1][0, 0] == 0.0


def test_phases_at_tiny_size(tmp_path, quiet_cli):
    """The em, indep and call phases end to end through the CLI, each
    within its tolerance of the exact engine on the subset."""
    paths = cs.make_inputs(str(tmp_path), TINY)
    report = cs.run_parity_phases(str(tmp_path), TINY, paths)
    assert set(report) == {"em", "em_scan", "indep", "call"}
    for r in report.values():
        assert r["err"] <= r["tol"]
    assert len(cs.read_dist(str(tmp_path / "indep.dist"))) == \
        TINY.boot_reps + 1


def test_kernel_vs_scan_interpret():
    got = cs.kernel_vs_scan(n_ind=9, n_sites=24, seed=2, interpret=True,
                            reps=1)
    assert got["memory"] is None
    assert np.isfinite(got["dist_max_abs"])
    assert got["kernel_s"] > 0 and got["scan_s"] > 0


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(cs.result_line([Dev()] * 4))["device"]["count"] == 4


def _run_script(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_fails_without_gpu():
    r = _run_script(os.path.join(REPO_ROOT, "chip_smoke.py"), REPO_ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_script_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_phases_on_card(gpu, tmp_path, quiet_cli):
    """The phases on the card at a small size (chip_smoke.py runs them
    at full size)."""
    sizes = cs.Sizes(n_ind=128, em_sites=512, indep_sites=2048,
                     subset=16, boot_reps=2, boot_block=256)
    paths = cs.make_inputs(str(tmp_path), sizes)
    for r in cs.run_parity_phases(str(tmp_path), sizes, paths).values():
        assert r["err"] <= r["tol"]
