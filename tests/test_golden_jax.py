"""Golden md5 parity for the BATCHED JAX engine on CPU x64.

The native exact engine carries the bit-parity contract by construction;
this suite pins the stronger property that the batched einsum/scan
engine (core/distance.py — including the vectorized EM and the
partial-sum bootstrap resummation) ALSO reproduces the reference's
C-double arithmetic byte-for-byte through %.10f formatting on every
golden config.  Deterministic reduction orders make this stable
(SURVEY.md §7 "hard parts").
"""

import hashlib
import json
import os

import pytest

from ngsdist_jax import cli

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_jax_engine_golden_md5(name, tmp_path, monkeypatch):
    monkeypatch.chdir(os.path.join(FIXTURES, "data"))
    case = MANIFEST[name]
    out = str(tmp_path / f"{name}.dist")
    args = [a.replace("{OUT}", out) for a in case["args"]]
    args += ["--engine", "jax", "--verbose", "0"]
    rc = cli.main(args)
    assert rc == 0
    md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
    assert md5 == case["md5"], f"{name}: jax-x64 output differs from golden"
