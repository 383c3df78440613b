"""Runtime `-k` kernel-width coverage (kw != 2).

The reference accepts any kernel half-width at runtime
(`src/tron.cu:827-828`) and threads it through every kernel evaluation
(`:465-577`).  Here kw is a ReconConfig field threaded the same way; these
tests pin kw = 1.5 and 3.0 through each layer: the KB polynomial the Triton
gridder evaluates, the gridder itself (interpreted) and the gather degrid,
the CGNR operator pair, and the full adjoint pipeline against the
exact-DTFT oracle (which has no kernel at all, so deapodization errors
cannot cancel).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.kernels.kb import kb_beta, kb_kernel
from tron_jax.nufft import nufft_adjoint, nufft_forward, sdc_weights
from tron_jax.ops import grid_triton
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.grid import grid_radial2d
from tron_jax.oracle import dtft2, dtft2_adjoint
from tron_jax.phantom import shepp_logan
from tron_jax.trajectory import spoke_angles
from tests.conftest import nrmse

KWS = [1.5, 3.0]


def _case(rng, C, npe, nro, skip=5):
    data = (
        rng.standard_normal((C, npe, nro)) + 1j * rng.standard_normal((C, npe, nro))
    ).astype(np.complex64)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, skip))
    return jnp.asarray(data), angles


def _triton(data, angles, nxos, kw, beta, **kwargs):
    return np.asarray(grid_triton.grid_radial2d_triton(
        data, angles, nxos, kw, beta, interpret=True, **kwargs))


@pytest.mark.parametrize("kw", KWS)
def test_kb_poly_accuracy(kw):
    """The polynomial KB window the Triton gridder evaluates must track the
    reference KB window at any kw (the fit degree adapts to beta: kw=3's
    beta=14.04 needs degree 13 where kw<=2 needs 9)."""
    beta = kb_beta(kw, 2.0)
    coeffs = grid_triton._kb_coeffs(kw, beta)
    x = jnp.linspace(-kw + 1e-3, kw - 1e-3, 4001)
    want = np.asarray(kb_kernel(x, kw, beta))
    got = np.asarray(grid_triton._kb_poly(x, kw, coeffs))
    # fit residual is <1e-7; the rest is fp32 Horner rounding over the
    # window's ~e^beta dynamic range (beta=14.04 at kw=3)
    rel = np.max(np.abs(got - want)) / np.max(want)
    assert rel < 4e-6, f"kb poly at kw={kw}: maxrel={rel:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_grid_kernel_kw(rng, kw):
    """Triton gridder (interpreted) vs the plain gridder at kw."""
    nxos = nro = 64
    beta = kb_beta(kw, 2.0)
    data, angles = _case(rng, 2, 9, nro)
    want = np.asarray(grid_radial2d(data, angles, nxos, kw, beta))
    err = nrmse(_triton(data, angles, nxos, kw, beta), want)
    assert err < 1e-5, f"grid kernel at kw={kw} nrmse={err:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_grid_kernel_kw_nondefault_gridos(rng, kw):
    """kw and gridos vary together (both are runtime flags in the
    reference): osf 1.5 exercises the non-identity radius map under a
    non-default kernel band."""
    nro = 64
    nxos = int((nro // 2) * 1.5)
    beta = kb_beta(kw, 1.5)
    data, angles = _case(rng, 1, 7, nro)
    want = np.asarray(grid_radial2d(data, angles, nxos, kw, beta))
    err = nrmse(_triton(data, angles, nxos, kw, beta), want)
    assert err < 1e-5, f"grid kernel at kw={kw}, osf=1.5 nrmse={err:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_degrid_kernel_kw(rng, kw):
    """Gather degrid vs the direct sum over the whole periodic grid at kw
    (every grid point, its KB weight at the wrapped distance)."""
    n, npe = 32, 5
    beta = kb_beta(kw, 2.0)
    g = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(
        np.complex64
    )
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 3))
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, kw, beta))
    kr = (np.arange(n) / n - 0.5) * n
    xs = kr[None, :] * np.cos(np.asarray(angles))[:, None] + n // 2
    ys = kr[None, :] * np.sin(np.asarray(angles))[:, None] + n // 2
    pos = np.arange(n)

    def w(d):
        d = np.mod(d + n / 2, n) - n / 2
        return np.asarray(kb_kernel(jnp.asarray(d, jnp.float32), kw, beta))

    A = w(xs[..., None] - pos)                   # (npe, nro, x)
    B = w(ys[..., None] - pos)                   # (npe, nro, y)
    want = np.einsum("pry,yx,prx->pr", B, g, A)
    err = nrmse(got, want)
    assert err < 2e-5, f"degrid at kw={kw} nrmse={err:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_exact_lattice_kw(rng, kw):
    """The exact-lattice Triton gridder vs the plain raw_rows gridder at
    kw != 2 (the KB band enters both weight generators)."""
    nro = nxos = 64
    beta = kb_beta(kw, 2.0)
    data, angles = _case(rng, 1, 6, nro)
    data = data.at[..., 0].set(0)
    want = np.asarray(grid_radial2d(data, angles, nxos, kw, beta, raw_rows=True))
    err = nrmse(_triton(data, angles, nxos, kw, beta, exact=True), want)
    assert err < 1e-5, f"exact-lattice gridder at kw={kw} nrmse={err:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_exact_pair_adjointness_kw(rng, kw):
    """Dot test at kw != 2: the exact-lattice gridder stays the transpose
    of the clip-mode gather degrid (the CGNR pair contract)."""
    nro = nxos = 64
    beta = kb_beta(kw, 2.0)
    angles = jnp.asarray(spoke_angles(5, AngleScheme.GOLDEN, 2))
    x = (rng.standard_normal((1, nxos, nxos))
         + 1j * rng.standard_normal((1, nxos, nxos))).astype(np.complex64)
    y = (rng.standard_normal((1, 5, nro))
         + 1j * rng.standard_normal((1, 5, nro))).astype(np.complex64)
    y[..., 0] = 0
    Ax = degrid_radial2d(jnp.asarray(x), angles, nro, kw, beta, wrap=False)
    AHy = _triton(jnp.asarray(y), angles, nxos, kw, beta, exact=True) * (nxos * 5)
    lhs = complex(jnp.vdot(jnp.asarray(y), Ax))
    rhs = complex(jnp.vdot(jnp.asarray(AHy), jnp.asarray(x)))
    rel = abs(lhs - rhs) / abs(rhs)
    assert rel < 1e-4, f"pair dot test at kw={kw}: rel={rel:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_adjoint_pipeline_vs_oracle_kw(rng, kw):
    """Full fast adjoint (grid + FFT + crop + deapod) at kw vs the
    exact-DTFT oracle adjoint with identical SDC weights.  The oracle has
    no interpolation kernel, so a kw-mismatched deapodization cannot
    cancel against a kw-mismatched gridder."""
    n, npe = 32, 64
    nro = nxos = 2 * n
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF, kernwidth=kw)
    img = shepp_logan(n)
    angles = np.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    kr = (np.arange(nro) / nro - 0.5) * nxos
    kx = (kr[None, :] * np.cos(angles)[:, None]).ravel().astype(np.float32)
    ky = (kr[None, :] * np.sin(angles)[:, None]).ravel().astype(np.float32)

    data = nufft_forward(jnp.asarray(img), jnp.asarray(angles), cfg)
    rec = np.asarray(nufft_adjoint(data, jnp.asarray(angles), cfg))

    w = np.asarray(sdc_weights(cfg, nro, npe))
    oracle_data = np.asarray(
        dtft2(jnp.asarray(img), jnp.asarray(kx), jnp.asarray(ky), nxos)
    ).reshape(npe, nro) * w
    oracle_data[:, 0] = 0
    oracle_rec = np.asarray(
        dtft2_adjoint(
            jnp.asarray(oracle_data.ravel()), jnp.asarray(kx), jnp.asarray(ky),
            n, nxos,
        )
    ) / (nxos * npe)
    err = nrmse(rec, oracle_rec)
    assert err < 5e-3, f"adjoint pipeline vs oracle at kw={kw}: nrmse={err:.2e}"


@pytest.mark.parametrize("kw", KWS)
def test_cgnr_converges_kw(rng, kw):
    """CGNR at kw != 2: a few iterations on undersampled phantom data must
    reduce the data residual ||A x - y|| below the plain adjoint's."""
    import dataclasses

    from tron_jax.solver import cgnr_radial2d

    n, npe = 32, 24
    nro = 2 * n
    cfg = ReconConfig(golden_angle=True, kernwidth=kw, backend="jnp")
    img = shepp_logan(n)[None]
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 0))
    data = nufft_forward(jnp.asarray(img), angles, cfg, nro=nro)

    def resid(x):
        pred = nufft_forward(x, angles, cfg, nro=nro)
        return float(jnp.linalg.norm(pred - data) / jnp.linalg.norm(data))

    adj = nufft_adjoint(data, angles, cfg)
    cfg8 = dataclasses.replace(cfg, niter=8)
    sol = cgnr_radial2d(data, angles, cfg8)
    assert resid(sol) < resid(adj), (
        f"CGNR at kw={kw} did not beat the adjoint residual: "
        f"{resid(sol):.3f} vs {resid(adj):.3f}"
    )
