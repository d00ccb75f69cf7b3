import os

# Tests run on the single CPU device (the dry-run sets its own XLA_FLAGS in a
# separate process; setting 512 here would slow every test 500x).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skipped without one")
