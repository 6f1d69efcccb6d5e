"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes (SURVEY.md section 4: multi-host
paths are validated on --xla_force_host_platform_device_count simulation
before real pod slices).
"""

import os

# Force CPU: the ambient environment presets JAX_PLATFORMS to a TPU
# platform, and unit tests must run on the virtual CPU mesh.  NOTE: pytest's
# plugin machinery imports jax BEFORE this conftest runs, and jax snapshots
# JAX_PLATFORMS at import — so the env var alone is too late; the config
# update below is what actually takes effect (it works as long as no backend
# has been initialized yet).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", (
    "tests must run on the virtual CPU mesh, got " + jax.default_backend())
assert len(jax.devices()) == 8, jax.devices()

import numpy as np
import pytest
import scipy.sparse as sp


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Bound in-process XLA:CPU JIT state.

    With the full suite in one process, the accumulated compiled-program
    state eventually segfaults XLA:CPU inside a later pjit compile
    (reproduced twice in round 3, always at whichever heavy compile runs
    ~70 programs in; any prefix subset passes).  Dropping executable
    caches between modules keeps the process under the threshold; the
    cost is only cross-module recompiles, which are mostly disjoint
    anyway.
    """
    yield
    import jax
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_sparse(n_rows, n_cols, density, seed=0, dtype=np.float64):
    """Random sparse matrix with exact-ish density, canonical COO."""
    rs = np.random.default_rng(seed)
    nnz = max(1, int(n_rows * n_cols * density))
    rows = rs.integers(0, n_rows, nnz)
    cols = rs.integers(0, n_cols, nnz)
    vals = rs.standard_normal(nnz).astype(dtype)
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    m.sum_duplicates()
    return m


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (the port's kernels "
        "on the card); the test decides inside itself and skips without one")
