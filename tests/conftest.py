import os
import sys

# Tests exercise the multi-device sharding path on a virtual 8-device CPU
# mesh with float64.  JAX_PLATFORMS, when set, is honoured: the tests
# marked `gpu` run on a card with JAX_PLATFORMS=cuda,cpu (see README).
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures")
DATA_DIR = os.path.join(FIXTURES, "data")
GOLDEN_DIR = os.path.join(FIXTURES, "golden")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running end-to-end tests"
    )
    config.addinivalue_line(
        "markers", "refab: randomized CLI A/B vs the locally built "
        "reference binary (opt-in: pytest -m refab)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; run with "
        "JAX_PLATFORMS=cuda,cpu pytest -m gpu)"
    )


def pytest_collection_modifyitems(config, items):
    # refab drives ~200 reference-binary + engine runs; keep it out of
    # the default suite unless explicitly requested via -m.
    if "refab" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(reason="opt-in: run with -m refab")
    for item in items:
        if "refab" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the first JAX device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES


@pytest.fixture(scope="session")
def data_dir():
    return DATA_DIR


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN_DIR
