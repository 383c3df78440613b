"""Reduced-precision device -> host readback (the --half path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tron_jax.utils.xfer import to_host_planes


@pytest.mark.parametrize("shape", [(8,), (3, 5), (2, 3, 4), (1, 1, 8, 8, 1)])
def test_planes_roundtrip(rng, shape):
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )
    re, im = to_host_planes(jnp.asarray(x))
    assert re.dtype == np.float32 and re.shape == x.shape
    np.testing.assert_array_equal(re + 1j * im, x)


def test_planes_half(rng):
    x = (rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))).astype(
        np.complex64
    )
    re, im = to_host_planes(jnp.asarray(x), np.float16)
    assert re.dtype == np.float16 and im.dtype == np.float16
    np.testing.assert_array_equal(re, x.real.astype(np.float16))
    np.testing.assert_array_equal(im, x.imag.astype(np.float16))


def test_complex64_moves_natively(rng):
    x = (rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))).astype(
        np.complex64
    )
    np.testing.assert_array_equal(np.asarray(jnp.asarray(x)), x)
