"""Test configuration: an 8-virtual-device CPU backend unless told otherwise.

Sharding is validated on a virtual CPU mesh (XLA host-platform device
count), the standard way to test meshes without several cards (SURVEY.md
§4). JAX_PLATFORMS picks the backend; unset, the tests run on the CPU. Tests
marked `gpu` need a card and skip on any other backend (run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`, one process per card).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from zvdb_tpu.utils.cache import setup_compile_cache  # noqa: E402

# persistent compile cache: repeated runs skip recompilation
setup_compile_cache()


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Free compiled executables between test modules.

    A single pytest process accumulates hundreds of XLA CPU executables; at
    ~module 19 of 26 the NEXT compile segfaults inside XLA
    (backend_compile_and_load — reproduced 3/3 on this image, same test,
    cold or warm persistent cache, while the same module passes in a fresh
    process). Dropping executable references between modules keeps the
    process below the crash threshold; the persistent compile cache makes
    re-compiles cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def on_gpu():
    """Skip unless the default backend is a GPU (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
