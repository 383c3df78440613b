"""Golden regression values: lock the user-visible numerical conventions
(scaling, angles, SDC, deapod) against drift.  The expected constants were
computed at a known-good revision on CPU fp32; tolerances allow backend
reassociation but not convention changes."""

import numpy as np
import jax.numpy as jnp

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.nufft import nufft_adjoint, nufft_forward
from tron_jax.phantom import shepp_logan
from tron_jax.trajectory import spoke_angles


def _fingerprint(x):
    """A few stable functionals of an array."""
    x = np.asarray(x)
    return np.array(
        [np.abs(x).sum(), np.abs(x).max(), float(np.abs(x.sum())), np.abs(x[..., ::7, ::7]).sum()]
    )


def test_forward_fingerprint():
    img = shepp_logan(32)
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    angles = jnp.asarray(spoke_angles(48, AngleScheme.LINEAR_HALF))
    data = np.asarray(nufft_forward(jnp.asarray(img), angles, cfg))
    got = _fingerprint(data)
    want = np.array([39169.7422, 129.9373, 15771.9873, 621.7408])
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_adjoint_fingerprint():
    img = shepp_logan(32)
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    angles = jnp.asarray(spoke_angles(48, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)
    rec = np.asarray(nufft_adjoint(data, angles, cfg))
    got = _fingerprint(rec)
    want = np.array([157.8703, 0.7631, 156.9158, 3.1219])
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_gridding_determinism():
    """The race-freedom story: identical inputs give bitwise-identical
    outputs (gather/matmul formulation — no scatter, no atomics).  The
    reference only gets this by construction on GPU; here it is asserted.
    """
    from tron_jax.ops.grid import grid_radial2d
    from tron_jax.kernels.kb import kb_beta

    rng = np.random.default_rng(7)
    data = (rng.standard_normal((2, 12, 64)) + 1j * rng.standard_normal((2, 12, 64))).astype(np.complex64)
    angles = jnp.asarray(spoke_angles(12, AngleScheme.GOLDEN, 5))
    a = np.asarray(grid_radial2d(jnp.asarray(data), angles, 64, 2.0, kb_beta(2.0, 2.0)))
    b = np.asarray(grid_radial2d(jnp.asarray(data), angles, 64, 2.0, kb_beta(2.0, 2.0)))
    np.testing.assert_array_equal(a, b)
