"""The FFT epilogue and prologue (cuFFT through jnp.fft on the GPU) vs an
explicit centered DFT, and the exact adjointness of the pair that CGNR's
operator dot test relies on."""

import jax.numpy as jnp
import numpy as np
import pytest

from tron_jax.kernels.kb import kb_beta, kb_hat
from tron_jax.ops.fftops import (
    centered_fft2,
    centered_ifft2_unnormalized,
    crop_center,
    deapod_weights,
    deapodize,
    pad_center,
)


def _dft(n: int, nxos: int) -> np.ndarray:
    """(n, nxos) centered inverse DFT restricted to the n-point center
    crop: M[y, v] = exp(+2i pi (y - n/2)(v - N/2) / N), in float64."""
    y = np.arange(n) - n / 2
    v = np.arange(nxos) - nxos / 2
    return np.exp((2j * np.pi / nxos) * np.outer(y, v))


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _g(n, nxos, kw, beta):
    u = (np.arange(n) - n // 2) / nxos
    return 1.0 / np.asarray(kb_hat(jnp.asarray(u, jnp.float32), kw, beta), np.float64)


@pytest.mark.parametrize("deapod", [True, False])
def test_adjoint_epilogue_matches_direct_dft(rng, deapod):
    nxos, n, kw = 64, 32, 2.0
    beta = kb_beta(kw, 2.0)
    K = _cplx(rng, (3, nxos, nxos))
    got = crop_center(centered_ifft2_unnormalized(jnp.asarray(K)), n)
    if deapod:
        got = deapodize(got, nxos, kw, beta)
    M = _dft(n, nxos)
    if deapod:
        M = _g(n, nxos, kw, beta)[:, None] * M
    want = np.einsum("yv,cvu,xu->cyx", M, K.astype(np.complex128), M)
    err = np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)
    assert err < 1e-5, err


@pytest.mark.parametrize("deapod", [True, False])
def test_forward_prologue_matches_direct_dft(rng, deapod):
    nxos, n, kw = 64, 32, 2.0
    beta = kb_beta(kw, 2.0)
    img = _cplx(rng, (2, n, n))
    x = pad_center(jnp.asarray(img), nxos)
    if deapod:
        x = deapodize(x, nxos, kw, beta)
    got = centered_fft2(x)
    Mh = np.conj(_dft(n, nxos))
    if deapod:
        Mh = _g(n, nxos, kw, beta)[:, None] * Mh
    want = np.einsum("yv,cyx,xu->cvu", Mh, img.astype(np.complex128), Mh)
    err = np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)
    assert err < 1e-5, err


def test_fft_pair_is_adjoint(rng):
    """<F x, y> = <x, F^H y> for pad+deapod+FFT and IFFT+crop+deapod."""
    nxos, n, kw = 64, 32, 2.0
    beta = kb_beta(kw, 2.0)
    x = jnp.asarray(_cplx(rng, (n, n)))
    y = jnp.asarray(_cplx(rng, (nxos, nxos)))
    Ax = centered_fft2(deapodize(pad_center(x, nxos), nxos, kw, beta))
    AHy = deapodize(crop_center(centered_ifft2_unnormalized(y), n), nxos, kw, beta)
    lhs = complex(jnp.vdot(Ax, y))
    rhs = complex(jnp.vdot(x, AHy))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


@pytest.mark.parametrize("n", [32, 48])
def test_centered_fft_roundtrip(rng, n):
    x = jnp.asarray(_cplx(rng, (2, n, n)))
    back = centered_ifft2_unnormalized(centered_fft2(x)) / (n * n)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), rtol=1e-5, atol=1e-5)


def test_crop_pad_adjoint(rng):
    x = jnp.asarray(_cplx(rng, (16, 16)))
    y = jnp.asarray(_cplx(rng, (40, 40)))
    lhs = complex(jnp.vdot(pad_center(x, 40), y))
    rhs = complex(jnp.vdot(x, crop_center(y, 16)))
    assert abs(lhs - rhs) < 1e-4 * abs(lhs)


def test_deapod_weights_separable():
    w = np.asarray(deapod_weights(16, 32, 2.0, kb_beta(2.0, 2.0)))
    np.testing.assert_allclose(w, np.outer(w[:, 8], w[8, :]) / w[8, 8], rtol=1e-6)
    assert w[8, 8] == w.max()


def test_deapod_passthrough_where_weight_nonpositive():
    """Pixels whose weight is <= 0 pass through (`src/tron.cu:400`)."""
    n, nxos, kw, beta = 32, 32, 2.0, 0.1
    img = jnp.ones((n, n), jnp.complex64)
    w = np.asarray(deapod_weights(n, nxos, kw, beta))
    out = np.asarray(deapodize(img, nxos, kw, beta))
    assert (w <= 0).any()
    np.testing.assert_array_equal(out[w <= 0], 1.0)
    np.testing.assert_allclose(out[w > 0], 1.0 / w[w > 0], rtol=1e-6)
