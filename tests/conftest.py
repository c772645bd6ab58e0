"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(the 512-placeholder env is exclusively the dry-run's, per assignment)."""
import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without "
        "one); README 'PyTorch / H100 port' says how to run them there")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
