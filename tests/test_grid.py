"""Adjoint gridding tests.

1. The dense-matmul gridder must equal a literal (slow, numpy) transcription
   of the reference's per-point banded gather — same math, independently
   evaluated.
2. The full adjoint pipeline must match (1/(nxos*npe)) * exact adjoint DTFT
   of the density-compensated data.
"""

import numpy as np
import jax.numpy as jnp

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.kernels.kb import kb_beta
from tron_jax.nufft import nufft_adjoint
from tron_jax.ops.grid import grid_radial2d
from tron_jax.oracle import dtft2_adjoint
from tron_jax.trajectory import ramlak_sdc, spoke_angles
from tests.conftest import nrmse


def _kb_np(x, kw, beta):
    import scipy.special

    r = np.abs(x) / kw
    out = np.where(r < 1, 0.5 * scipy.special.i0(beta * np.sqrt(np.clip(1 - r * r, 0, None))) / kw, 0.0)
    return out


def _grid_bruteforce(data, angles, nxos, kw, beta, nro):
    """Direct O(n^2 * npe * nR) evaluation of the gridding sum."""
    npe = len(angles)
    C = data.shape[0]
    out = np.zeros((C, nxos, nxos), dtype=np.complex128)
    X = np.arange(nxos) - nxos // 2
    rr = np.arange(-(nxos // 2) + 1, nxos // 2)  # |r| <= nxos/2 - 1
    ridx = np.trunc(rr * nro / nxos).astype(int) + nro // 2
    for p, t in enumerate(angles):
        kx = rr * np.cos(t)
        ky = rr * np.sin(t)
        wx = _kb_np(kx[:, None] - X[None, :], kw, beta)  # (nR, nx)
        wy = _kb_np(ky[:, None] - X[None, :], kw, beta)  # (nR, ny)
        s = data[:, p, ridx]  # (C, nR)
        out += np.einsum("ry,rx,cr->cyx", wy, wx, s)
    return out / (nxos * npe)


def test_grid_matches_bruteforce(rng):
    n, npe = 16, 12
    nro = nxos = 2 * n
    kw = 2.0
    beta = kb_beta(kw, 2.0)
    data = (rng.standard_normal((2, npe, nro)) + 1j * rng.standard_normal((2, npe, nro))).astype(
        np.complex64
    )
    angles = np.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    got = np.asarray(grid_radial2d(jnp.asarray(data), jnp.asarray(angles), nxos, kw, beta))
    want = _grid_bruteforce(data, angles, nxos, kw, beta, nro)
    assert nrmse(got, want) < 2e-4  # fp32 accumulation vs fp64 brute force


def test_grid_pe_chunk_invariance(rng):
    n, npe = 8, 10
    nro = nxos = 16
    beta = kb_beta(2.0, 2.0)
    data = (rng.standard_normal((1, npe, nro)) + 1j * rng.standard_normal((1, npe, nro))).astype(
        np.complex64
    )
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 3))
    a = np.asarray(grid_radial2d(jnp.asarray(data), angles, nxos, 2.0, beta, pe_chunk=1))
    b = np.asarray(grid_radial2d(jnp.asarray(data), angles, nxos, 2.0, beta, pe_chunk=4))
    c = np.asarray(grid_radial2d(jnp.asarray(data), angles, nxos, 2.0, beta, pe_chunk=10))
    assert nrmse(a, b) < 1e-6 and nrmse(a, c) < 1e-6


def test_adjoint_pipeline_vs_dtft():
    """On realistic (decaying-spectrum) radial data, the full adjoint
    pipeline must match (1/(nxos*npe)) * exact weighted adjoint DTFT."""
    from tron_jax.phantom import shepp_logan_kspace

    n, npe = 32, 64
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF, adjoint=True)
    nro = nxos = 2 * n
    angles = np.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    kr = (np.arange(nro) / nro - 0.5) * nxos
    kx = (kr[None, :] * np.cos(angles)[:, None]).astype(np.float32)
    ky = (kr[None, :] * np.sin(angles)[:, None]).astype(np.float32)
    # exact continuous phantom k-space as input data
    data = shepp_logan_kspace(kx / cfg.gridos, ky / cfg.gridos, n).astype(np.complex64)
    # the gridder never touches readout 0 (radius -nro/2, a reference
    # convention: the band is clamped to |r| <= nxos/2-1); align the oracle
    data[:, 0] = 0

    got = np.asarray(nufft_adjoint(jnp.asarray(data), jnp.asarray(angles), cfg))

    sdc = np.asarray(ramlak_sdc(nro, npe))
    wdata = (data * sdc).ravel()
    want = np.asarray(
        dtft2_adjoint(jnp.asarray(wdata), jnp.asarray(kx.ravel()), jnp.asarray(ky.ravel()), n, nxos)
    )
    want = want / (nxos * npe)
    err = nrmse(got, want)
    assert err < 5e-3, f"adjoint vs DTFT nrmse={err:.2e}"  # J=4/osf=2 interp error
