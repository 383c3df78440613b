"""CGNR iterative recon: must actually work (the reference's is broken,
src/tron.cu:670) — iterations should *reduce* data-domain residual and beat
the plain adjoint on undersampled data."""

import pytest
import numpy as np
import jax.numpy as jnp

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.nufft import nufft_forward
from tron_jax.phantom import shepp_logan
from tron_jax.solver import cgnr_radial2d
from tron_jax.trajectory import spoke_angles
from tests.conftest import lmse


def test_cgnr_improves_on_adjoint():
    n, npe = 32, 24  # undersampled (npe < pi/2 n)
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)

    from tron_jax.nufft import nufft_adjoint

    adj = np.asarray(nufft_adjoint(data, angles, cfg))
    x10 = np.asarray(cgnr_radial2d(data, angles, cfg, niter=10))

    e_adj = lmse(adj, img)
    e_cg = lmse(x10, img)
    assert e_cg < e_adj, f"CGNR ({e_cg:.3f}) should beat adjoint ({e_adj:.3f})"


def test_cgnr_monotone_data_residual():
    n, npe = 24, 16
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)

    prev = np.inf
    for it in [1, 4, 12]:
        x = cgnr_radial2d(data, angles, cfg, niter=it)
        resid = float(jnp.linalg.norm(nufft_forward(x, angles, cfg) - data))
        assert resid < prev * 1.01
        prev = resid


def test_cgnr_operator_pair():
    """The explicit fast-kernel operator pair (grid as degrid's clip-mode
    adjoint): verified adjoint to ~1e-4, and its CGNR must converge like
    the transpose mode.  The two modes treat the outermost k-space ring
    differently (clip + drop readout 0 vs periodic wrap), so solutions
    agree closely but not bitwise — tightly at realistic sizes, loosely at
    the tiny n used here where the ring carries visible energy."""
    n, npe = 24, 20
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)
    xt = np.asarray(cgnr_radial2d(data, angles, cfg, niter=6, operators="transpose"))
    xp = np.asarray(cgnr_radial2d(data, angles, cfg, niter=6, operators="pair"))
    err = np.linalg.norm(xp - xt) / np.linalg.norm(xt)
    assert err < 0.15, f"pair vs transpose CGNR nrmse={err:.2e}"
    # pair mode must actually solve its problem: beat the plain adjoint
    from tron_jax.nufft import nufft_adjoint
    from tests.conftest import lmse

    adj = np.asarray(nufft_adjoint(data, angles, cfg))
    assert lmse(xp, img) < lmse(adj, img)


def test_toeplitz_apply_matches_exact_normal_operator(rng):
    """toeplitz_apply with the exact-DTFT kernel must equal the literal
    E^H W E (exact NUFFT normal operator) applied via dtft2 / dtft2_adjoint."""
    from tron_jax.nufft import sdc_weights
    from tron_jax.oracle import dtft2, dtft2_adjoint
    from tron_jax.solver import toeplitz_apply, toeplitz_fourier_kernel

    n, npe = 16, 11
    nro = 2 * n
    cfg = ReconConfig(golden_angle=True)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 0))
    x = (rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))).astype(
        np.complex64
    )

    mult = toeplitz_fourier_kernel(angles, cfg, nro, method="exact")
    got = np.asarray(toeplitz_apply(jnp.asarray(x), mult))

    kr = (np.arange(nro) / nro - 0.5) * nro
    ang = np.asarray(angles)
    kx = jnp.asarray((kr[None, :] * np.cos(ang)[:, None]).reshape(-1).astype(np.float32))
    ky = jnp.asarray((kr[None, :] * np.sin(ang)[:, None]).reshape(-1).astype(np.float32))
    w = np.asarray(sdc_weights(cfg, nro, npe)).copy()
    w[0] = 0
    wfull = np.broadcast_to(w[None, :], (npe, nro)).reshape(-1)
    y = np.asarray(dtft2(jnp.asarray(x), kx, ky, nro))
    want = np.asarray(dtft2_adjoint(jnp.asarray(y * wfull), kx, ky, n, nro))

    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 5e-5, f"toeplitz vs literal normal operator: {err:.2e}"


def test_toeplitz_nufft_kernel_matches_exact(rng):
    """The fast (gridded) PSF kernel must agree with the exact-DTFT kernel
    to NUFFT accuracy."""
    from tron_jax.solver import toeplitz_fourier_kernel

    n, npe = 32, 24
    nro = 2 * n
    cfg = ReconConfig(golden_angle=True)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 0))
    exact = np.asarray(toeplitz_fourier_kernel(angles, cfg, nro, method="exact"))
    fast = np.asarray(toeplitz_fourier_kernel(angles, cfg, nro, method="nufft"))
    err = np.linalg.norm(fast - exact) / np.linalg.norm(exact)
    assert err < 2e-3, f"gridded vs exact PSF kernel: {err:.2e}"


def test_toeplitz_nufft_method_requires_gridos2(rng):
    """The doubled-frequency embedding only holds at gridos == 2 (other osf
    put the even-slot samples at the wrong doubled frequencies — measured
    0.48-1.0 NRMSE); forcing method='nufft' elsewhere must raise, and
    method='auto' must fall back to the exact kernel."""
    from tron_jax.solver import toeplitz_fourier_kernel

    n, npe = 32, 24
    nro = 2 * n
    cfg = ReconConfig(golden_angle=True, gridos=1.5)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 0))
    with pytest.raises(ValueError, match="gridos"):
        toeplitz_fourier_kernel(angles, cfg, nro, method="nufft")
    # auto falls back to exact (no warning at this small n)
    exact = np.asarray(toeplitz_fourier_kernel(angles, cfg, nro, method="exact"))
    auto = np.asarray(toeplitz_fourier_kernel(angles, cfg, nro, method="auto"))
    np.testing.assert_array_equal(auto, exact)


def test_cgnr_toeplitz_matches_operator_mode():
    """CGNR with the Toeplitz normal operator must land on (essentially) the
    same solution as the operator pair/transpose mode — the two normal
    operators differ only at the NUFFT approximation level."""
    n, npe = 32, 24
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)

    x_op = np.asarray(cgnr_radial2d(data, angles, cfg, niter=8))
    x_tp = np.asarray(cgnr_radial2d(data, angles, cfg, niter=8, operators="toeplitz"))
    err = np.linalg.norm(x_tp - x_op) / np.linalg.norm(x_op)
    assert err < 2e-2, f"toeplitz vs operator CGNR solutions: {err:.2e}"

    # ReconConfig(toeplitz=True) must select the Toeplitz operators even for
    # direct cgnr_radial2d callers (operators="auto" resolves the flag)
    import dataclasses

    cfg_flag = dataclasses.replace(cfg, toeplitz=True)
    x_flag = np.asarray(cgnr_radial2d(data, angles, cfg_flag, niter=8))
    np.testing.assert_array_equal(x_flag, x_tp)

    from tron_jax.nufft import nufft_adjoint

    e_adj = lmse(np.asarray(nufft_adjoint(data, angles, cfg)), img)
    e_tp = lmse(x_tp, img)
    assert e_tp < e_adj, f"toeplitz CGNR ({e_tp:.3f}) should beat adjoint ({e_adj:.3f})"


@pytest.mark.parametrize("gridos", [1.5, 2.5])
def test_cgnr_operator_pair_nondefault_gridos(rng, gridos):
    """Pair mode at gridos != 2: the adjoint resamples readouts onto the
    grid-radius lattice, so the pair forward is the lattice degrid followed
    by the resample transpose (solver.py).  Its CGNR must track the
    exact-transpose mode and beat the plain adjoint."""
    n, npe = 24, 20
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF, gridos=gridos)
    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    # synthesize at the ACQUISITION readout count (nro = 2n); nufft_forward's
    # default nro=nxos would shrink the solver's geometry at gridos != 2
    data = nufft_forward(jnp.asarray(img), angles, cfg, nro=2 * n)
    xt = np.asarray(cgnr_radial2d(data, angles, cfg, niter=6, operators="transpose"))
    xp = np.asarray(cgnr_radial2d(data, angles, cfg, niter=6, operators="pair"))
    err = np.linalg.norm(xp - xt) / np.linalg.norm(xt)
    assert err < 0.15, f"pair vs transpose CGNR at gridos={gridos} nrmse={err:.2e}"
    from tron_jax.nufft import nufft_adjoint
    from tests.conftest import lmse

    adj = np.asarray(nufft_adjoint(data, angles, cfg))
    assert lmse(xp, img) < lmse(adj, img)
