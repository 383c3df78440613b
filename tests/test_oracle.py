"""DTFT oracle self-tests: against brute force, FFT, adjointness, and the
analytic Shepp-Logan k-space."""

import numpy as np
import jax.numpy as jnp

from tron_jax.oracle import dtft2, dtft2_adjoint
from tron_jax.phantom import shepp_logan, shepp_logan_kspace
from tests.conftest import nrmse


def test_dtft_matches_fft_on_grid_points(rng):
    n = 16
    img = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    # on-integer-grid frequencies of the same-size transform: must equal
    # the centered FFT exactly
    u = np.arange(n) - n // 2
    kx, ky = np.meshgrid(u, u, indexing="xy")
    got = np.asarray(dtft2(jnp.asarray(img), kx.ravel().astype(np.float32),
                           ky.ravel().astype(np.float32), n)).reshape(n, n)
    want = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img)))
    # meshgrid xy: rows vary ky? build want indexed [ky, kx]
    assert nrmse(got, want) < 1e-5


def test_dtft_adjointness(rng):
    n, m, nos = 8, 37, 16
    img = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    y = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    kx = rng.uniform(-nos / 2, nos / 2, m).astype(np.float32)
    ky = rng.uniform(-nos / 2, nos / 2, m).astype(np.float32)
    Ax = np.asarray(dtft2(jnp.asarray(img), kx, ky, nos))
    Aty = np.asarray(dtft2_adjoint(jnp.asarray(y), kx, ky, n, nos))
    # <y, A x> == <A^H y, x>
    lhs = np.vdot(y, Ax)
    rhs = np.vdot(Aty, img)
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_batched_dims(rng):
    n, m, nos = 8, 11, 16
    img = rng.standard_normal((3, n, n)).astype(np.complex64)
    kx = rng.uniform(-8, 8, m).astype(np.float32)
    ky = rng.uniform(-8, 8, m).astype(np.float32)
    out = np.asarray(dtft2(jnp.asarray(img), kx, ky, nos))
    assert out.shape == (3, m)
    for c in range(3):
        single = np.asarray(dtft2(jnp.asarray(img[c]), kx, ky, nos))
        np.testing.assert_allclose(out[c], single, rtol=1e-5, atol=1e-4)


def test_shepp_logan_kspace_vs_dtft():
    """Analytic ellipse FT should match the DTFT of the rasterized phantom to
    within discretization error at low-to-mid frequencies."""
    n = 64
    nos = 2 * n
    img = shepp_logan(n)
    theta = np.linspace(0, np.pi, 12, endpoint=False)
    r = np.arange(-24, 24, dtype=np.float64) * 2.0  # grid-unit radii of nos grid
    kx = (r[None, :] * np.cos(theta)[:, None]).ravel()
    ky = (r[None, :] * np.sin(theta)[:, None]).ravel()
    # dtft frequencies are in nos units; analytic expects cycles/FOV of the
    # original n-grid = k_nos / gridos
    got = np.asarray(dtft2(jnp.asarray(img), kx.astype(np.float32), ky.astype(np.float32), nos))
    want = shepp_logan_kspace(kx / 2.0, ky / 2.0, n)
    assert nrmse(got, want) < 0.08  # rasterization error dominates


def test_phantom_basic():
    img = shepp_logan(64)
    assert img.shape == (64, 64)
    assert img.dtype == np.complex64
    assert abs(img[32, 32] - (1.0 - 0.8)) < 1e-6  # center: e1 + e2 only
    assert img[0, 0] == 0


def test_phase_fp32_exact_at_large_k():
    """_phase must stay phase-accurate at |k*p| ~ 3e4 (512-readout whole-body
    geometry) where a naive fp32 k*p*2pi/nos loses ~2.4e-5 rad."""
    from tron_jax.oracle.dtft import _phase

    n, nos = 256, 512
    k = np.array([255.5, -255.5, 199.874, 83.0001], dtype=np.float32)
    got = np.asarray(_phase(n, nos, jnp.asarray(k)))
    p = (np.arange(n) - n // 2).astype(np.float64)
    want = np.exp(-2j * np.pi * k.astype(np.float64)[:, None] * p[None, :] / nos)
    assert np.abs(got - want).max() < 3e-6


def test_chunked_adjoint_matches_unchunked(rng):
    from tron_jax.oracle import dtft2_adjoint_chunked

    n, m, nos = 16, 101, 32  # m deliberately not a chunk multiple
    y = (rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))).astype(
        np.complex64
    )
    kx = rng.uniform(-nos / 2, nos / 2, m).astype(np.float32)
    ky = rng.uniform(-nos / 2, nos / 2, m).astype(np.float32)
    want = np.asarray(dtft2_adjoint(jnp.asarray(y), kx, ky, n, nos))
    got = np.asarray(
        dtft2_adjoint_chunked(jnp.asarray(y), jnp.asarray(kx), jnp.asarray(ky), n, nos, chunk=16)
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_oracle_adjoint_recon_matches_inline_recipe(rng):
    """oracle_adjoint_recon is the ONE canonical weighting/scaling recipe
    (Ram-Lak SDC, readout 0 zeroed, chunked DTFT adjoint, 1/(nro*npe));
    pin it against the recipe spelled out inline so callers can't drift."""
    from tron_jax.config import ReconConfig
    from tron_jax.nufft import sdc_weights
    from tron_jax.oracle import dtft2_adjoint_chunked, oracle_adjoint_recon
    from tron_jax.trajectory import spoke_angles

    n, nc, npe = 16, 2, 12
    nro = 2 * n
    cfg = ReconConfig(backend="jnp", golden_angle=True)
    data = (
        rng.standard_normal((nc, npe, nro)) + 1j * rng.standard_normal((nc, npe, nro))
    ).astype(np.complex64)
    angles = jnp.asarray(spoke_angles(npe, "golden", 0))

    got = np.asarray(oracle_adjoint_recon(jnp.asarray(data), angles, cfg, n, nro))

    kr = (np.arange(nro) / nro - 0.5) * nro
    kx = (kr[None, :] * np.cos(np.asarray(angles))[:, None]).reshape(-1)
    ky = (kr[None, :] * np.sin(np.asarray(angles))[:, None]).reshape(-1)
    wd = data * np.asarray(sdc_weights(cfg, nro, npe), dtype=np.complex64)
    wd[..., 0] = 0
    want = np.asarray(
        dtft2_adjoint_chunked(
            jnp.asarray(wd.reshape(nc, -1)),
            jnp.asarray(kx.astype(np.float32)),
            jnp.asarray(ky.astype(np.float32)),
            n,
            nro,
        )
    ) / (nro * npe)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert got.shape == (nc, n, n)
