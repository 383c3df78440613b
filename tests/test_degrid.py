"""Forward pipeline vs the exact DTFT oracle.

Gridding theory check: the KB window kb_kernel and its transform kb_hat are
an exact FT pair, so pad -> divide-by-kb_hat -> FFT -> KB-degrid should
reproduce DTFT samples to within the J=4/osf=2 interpolation error (~1e-3).
"""

import numpy as np
import jax.numpy as jnp

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.nufft import nufft_forward
from tron_jax.oracle import dtft2
from tron_jax.phantom import shepp_logan
from tron_jax.trajectory import spoke_angles
from tests.conftest import nrmse


def _traj(nro, npe, nxos, scheme, skip=0):
    angles = np.asarray(spoke_angles(npe, scheme, skip))
    kr = (np.arange(nro) / nro - 0.5) * nxos
    kx = (kr[None, :] * np.cos(angles)[:, None]).ravel()
    ky = (kr[None, :] * np.sin(angles)[:, None]).ravel()
    return angles, kx.astype(np.float32), ky.astype(np.float32)


def _check_forward(scheme, n=32, npe=48, golden=False, skip=0):
    cfg = ReconConfig(golden_angle=golden, skip_angles=skip, angle_scheme=None if golden else scheme)
    nro = int(cfg.gridos * n)
    nxos = nro
    img = shepp_logan(n)
    sch = cfg.scheme_for("forward")
    angles, kx, ky = _traj(nro, npe, nxos, sch, skip)
    got = np.asarray(nufft_forward(jnp.asarray(img), jnp.asarray(angles), cfg, nro=nro))
    want = np.asarray(dtft2(jnp.asarray(img), kx, ky, nxos)).reshape(npe, nro)
    err = nrmse(got, want)
    assert err < 2e-3, f"{scheme}: forward vs DTFT nrmse={err:.2e}"


def test_forward_linear_half():
    _check_forward(AngleScheme.LINEAR_HALF)


def test_forward_linear_full():
    _check_forward(AngleScheme.LINEAR_FULL)


def test_forward_golden_with_skip():
    _check_forward(AngleScheme.GOLDEN, golden=True, skip=7)


def test_forward_multichannel_batch(rng):
    """Batched channels must agree exactly with per-channel calls."""
    n, npe = 16, 24
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    nro = int(cfg.gridos * n)
    imgs = (rng.standard_normal((3, n, n)) + 1j * rng.standard_normal((3, n, n))).astype(
        np.complex64
    )
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    got = np.asarray(nufft_forward(jnp.asarray(imgs), angles, cfg, nro=nro))
    assert got.shape == (3, npe, nro)
    for c in range(3):
        one = np.asarray(nufft_forward(jnp.asarray(imgs[c]), angles, cfg, nro=nro))
        np.testing.assert_allclose(got[c], one, rtol=1e-5, atol=1e-5)


def test_forward_beatty_beta():
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF, beatty=True)
    n, npe = 32, 48
    nro = int(cfg.gridos * n)
    img = shepp_logan(n)
    angles, kx, ky = _traj(nro, npe, nro, AngleScheme.LINEAR_HALF)
    got = np.asarray(nufft_forward(jnp.asarray(img), jnp.asarray(angles), cfg, nro=nro))
    want = np.asarray(dtft2(jnp.asarray(img), kx, ky, nro)).reshape(npe, nro)
    assert nrmse(got, want) < 2e-3


def test_wrap_edge_patch_matches_dense_wrap(rng):
    """Wrap-mode degrid at the boundary-crossing readouts equals the direct
    sum over the periodic grid (the reference's periodic domain,
    src/tron.cu:569-570), and differs there from clip mode."""
    from tests.test_degrid_gather import _direct
    from tron_jax.kernels.kb import kb_beta
    from tron_jax.ops.degrid import degrid_radial2d

    n, C, npe = 64, 2, 37
    kw, beta = 2.0, kb_beta(2.0, 2.0)
    g = (rng.standard_normal((C, n, n)) + 1j * rng.standard_normal((C, n, n))).astype(
        np.complex64
    )
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 2))
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, kw, beta))
    want = _direct(g, angles, n, kw, beta, wrap=True)
    assert nrmse(got, want) < 1e-6
    edge = np.r_[0:4, n - 4 : n]
    assert nrmse(got[..., edge], want[..., edge]) < 1e-6
    clip = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, kw, beta, wrap=False))
    assert nrmse(clip, want) > 1e-4
