"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-card sharding logic is exercised without a GPU (SURVEY.md §4).

Tests marked ``gpu`` need the card: they skip elsewhere, decided by a
fixture at run time.  TRON_GPU_TESTS=1 leaves the platform as it is, for
the run of those tests on the card (chip_smoke.py, or
``TRON_GPU_TESTS=1 python -m pytest -m gpu tests/``)."""

import os

if os.environ.get("TRON_GPU_TESTS", "") in ("", "0"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marked_tests_need_a_gpu(request):
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernel compiled for the card")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def nrmse(a, b):
    """Normalized RMSE, the reference's accuracy metric (src/rmse.m, lmse.m)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def lmse(a, b):
    """Least-squares-scaled NRMSE (scale-invariant), like src/lmse.m."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    s = np.vdot(a, b) / np.vdot(a, a)
    return nrmse(s * a, b)
