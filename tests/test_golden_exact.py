"""Golden md5-parity tests: the exact engine must reproduce the reference
binary's output byte-for-byte on every config in the fixture manifest
(mirroring the reference's md5-based test strategy, examples/test.sh:47-56
and test.md5)."""

import hashlib
import json
import os

import pytest

from ngsdist_jax import cli, runner

from conftest import DATA_DIR, FIXTURES, GOLDEN_DIR

with open(os.path.join(FIXTURES, "manifest.json")) as fh:
    MANIFEST = json.load(fh)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_exact(name, tmp_path, monkeypatch):
    cfg = MANIFEST[name]
    out = tmp_path / f"{name}.dist"
    argv = [a.replace("{OUT}", str(out)) for a in cfg["args"]]
    monkeypatch.chdir(DATA_DIR)
    pars, _ = cli.parse_args(argv)
    pars.verbose = 0
    runner.run(pars, engine="exact")
    got = hashlib.md5(out.read_bytes()).hexdigest()
    assert got == cfg["md5"], (
        f"{name}: output differs from reference golden "
        f"(got {got}, want {cfg['md5']})"
    )


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_golden_bytes_exist(name):
    # The checked-in golden file must itself match its manifest md5.
    path = os.path.join(GOLDEN_DIR, f"{name}.dist")
    got = hashlib.md5(open(path, "rb").read()).hexdigest()
    assert got == MANIFEST[name]["md5"]
