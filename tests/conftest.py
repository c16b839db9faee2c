"""Test configuration: a virtual 8-device CPU mesh by default.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count). Set SPSP_TEST_PLATFORM=gpu to
run on the GPU instead: the tests marked `gpu` then run, and the rest
run on the card as well (`make test-gpu`).
"""

import os
import sys

_PLATFORM = os.environ.get("SPSP_TEST_PLATFORM", "cpu")

if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    # jax may already be imported (and configured) by a plugin before
    # this conftest; re-pin the platform. XLA_FLAGS is read lazily at
    # backend init, so the 8-device CPU mesh still takes effect as long
    # as no jax.devices() call happened yet.
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_platforms", "cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(_REPO, "build", "jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from tests.make_data import make_all  # noqa: E402


@pytest.fixture(scope="session")
def datadir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    return make_all(str(d))


@pytest.fixture(scope="session")
def goldendir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU. Decided when
    the test runs, never at import: every xdist worker must collect the
    same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (SPSP_TEST_PLATFORM=gpu)")
