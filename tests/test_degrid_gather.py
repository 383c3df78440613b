"""The gather degrid (the forward path on every platform) vs the direct
sum over the whole grid, in both edge conventions: periodic wrap (the
reference, `src/tron.cu:569-570`) and clip (the transpose of the gridder)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tron_jax.config import AngleScheme
from tron_jax.kernels.kb import kb_beta, kb_kernel
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.grid import grid_radial2d
from tron_jax.trajectory import spoke_angles
from tests.conftest import nrmse


def _grid(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _direct(g, angles, nro, kw, beta, wrap):
    """s[p, ro] = sum_{y,x} KB(ys - y) KB(xs - x) g[y, x] over every grid
    point, at the wrapped distance (wrap) or the plain one (clip)."""
    # sample positions in float32, as the gather computes them: the KB
    # window jumps at the edge of its support, so a sample at an integer
    # distance kw must round the same way in both
    n = g.shape[-1]
    kr = (np.arange(nro, dtype=np.float32) / nro - 0.5) * n
    xs = kr[None, :] * np.asarray(jnp.cos(angles))[:, None] + n // 2
    ys = kr[None, :] * np.asarray(jnp.sin(angles))[:, None] + n // 2
    pos = np.arange(n, dtype=np.float32)

    def w(d):
        if wrap:
            d = np.where(d >= n / 2, d - n, np.where(d < -n / 2, d + n, d))
        return np.asarray(kb_kernel(jnp.asarray(d), kw, beta), np.float64)

    A = w(xs[..., None] - pos)
    B = w(ys[..., None] - pos)
    return np.einsum("pry,...yx,prx->...pr", B, g.astype(np.complex128), A)


@pytest.mark.parametrize(
    "C,npe,n,wrap",
    [(2, 12, 64, True), (1, 23, 96, True), (2, 12, 64, False), (1, 23, 96, False)],
)
def test_gather_matches_direct(rng, C, npe, n, wrap):
    beta = kb_beta(2.0, 2.0)
    g = _grid(rng, (C, n, n))
    angles = spoke_angles(npe, AngleScheme.GOLDEN, 7)
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, 2.0, beta, wrap=wrap))
    assert nrmse(got, _direct(g, angles, n, 2.0, beta, wrap)) < 2e-6


@pytest.mark.parametrize("scheme", [AngleScheme.LINEAR_HALF, AngleScheme.LINEAR_FULL])
def test_linear_schemes(rng, scheme):
    n, beta = 64, kb_beta(2.0, 2.0)
    g = _grid(rng, (1, n, n))
    angles = spoke_angles(10, scheme)
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, 2.0, beta))
    assert nrmse(got, _direct(g, angles, n, 2.0, beta, True)) < 2e-6


@pytest.mark.parametrize("gridos", [1.5, 2.5])
def test_nondefault_gridos(rng, gridos):
    """nro != grid size: samples sit at (ro/nro - 1/2) * nxos."""
    nro = 64
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(2.0, gridos)
    g = _grid(rng, (1, nxos, nxos))
    angles = spoke_angles(7, AngleScheme.GOLDEN, 3)
    for wrap in (True, False):
        got = np.asarray(
            degrid_radial2d(jnp.asarray(g), angles, nro, 2.0, beta, wrap=wrap)
        )
        assert nrmse(got, _direct(g, angles, nro, 2.0, beta, wrap)) < 2e-6


@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_clip_is_transpose_of_plain_gridder(rng, gridos):
    """Dot test: the clip-mode gather is the transpose of the plain
    exact-radius gridder (the CGNR pair contract on the CPU)."""
    nro, npe = 64, 5
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(2.0, gridos)
    angles = spoke_angles(npe, AngleScheme.GOLDEN, 2)
    x = _grid(rng, (1, nxos, nxos))
    y = _grid(rng, (1, npe, nro))
    y[..., 0] = 0
    Ax = degrid_radial2d(jnp.asarray(x), angles, nro, 2.0, beta, wrap=False)
    AHy = grid_radial2d(
        jnp.asarray(y), angles, nxos, 2.0, beta, raw_rows=True
    ) * (nxos * npe)
    lhs = complex(jnp.vdot(jnp.asarray(y), Ax))
    rhs = complex(jnp.vdot(AHy, jnp.asarray(x)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


def test_wrap_and_clip_agree_in_the_interior(rng):
    """The conventions differ only where a footprint crosses the edge."""
    n, kw = 64, 2.0
    beta = kb_beta(kw, 2.0)
    g = jnp.asarray(_grid(rng, (1, n, n)))
    angles = spoke_angles(9, AngleScheme.GOLDEN, 1)
    a = np.asarray(degrid_radial2d(g, angles, n, kw, beta, wrap=True))
    b = np.asarray(degrid_radial2d(g, angles, n, kw, beta, wrap=False))
    ro = np.arange(n)
    inner = np.abs(ro - n // 2) <= n // 2 - kw - 1
    np.testing.assert_allclose(a[..., inner], b[..., inner], rtol=1e-6, atol=1e-6)
    assert not np.allclose(a[..., ~inner], b[..., ~inner])


def test_batch_dims(rng):
    n, beta = 32, kb_beta(2.0, 2.0)
    g = _grid(rng, (2, 3, n, n))
    angles = spoke_angles(6, AngleScheme.GOLDEN, 0)
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, 2.0, beta))
    assert got.shape == (2, 3, 6, n)
    for i in range(2):
        want = np.asarray(degrid_radial2d(jnp.asarray(g[i]), angles, n, 2.0, beta))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)


def test_vmap_over_frames(rng):
    n, beta = 32, kb_beta(2.0, 2.0)
    g = jnp.asarray(_grid(rng, (3, 1, n, n)))
    skips = jnp.asarray([0.0, 4.0, 9.0])

    def one(x, skip):
        return degrid_radial2d(
            x, spoke_angles(6, AngleScheme.GOLDEN, skip), n, 2.0, beta
        )

    got = np.asarray(jax.vmap(one)(g, skips))
    for f in range(3):
        np.testing.assert_allclose(
            got[f], np.asarray(one(g[f], skips[f])), rtol=1e-6, atol=1e-6
        )


def test_forward_pipeline_edges(rng):
    """nufft_forward's wrap flag reaches the degrid: clip and wrap differ
    only at the outermost readouts."""
    from tron_jax.config import ReconConfig
    from tron_jax.nufft import nufft_forward

    n = 32
    img = jnp.asarray(_grid(rng, (1, n, n)))
    angles = spoke_angles(8, AngleScheme.GOLDEN, 0)
    cfg = ReconConfig(golden_angle=True)
    a = np.asarray(nufft_forward(img, angles, cfg, wrap=True))
    b = np.asarray(nufft_forward(img, angles, cfg, wrap=False))
    ro = np.arange(2 * n)
    inner = np.abs(ro - n) <= n - 3
    np.testing.assert_allclose(a[..., inner], b[..., inner], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [1.5, 3.0])
def test_kernel_widths(rng, kw):
    n = 64
    beta = kb_beta(kw, 2.0)
    g = _grid(rng, (1, n, n))
    angles = spoke_angles(7, AngleScheme.GOLDEN, 2)
    got = np.asarray(degrid_radial2d(jnp.asarray(g), angles, n, kw, beta))
    assert nrmse(got, _direct(g, angles, n, kw, beta, True)) < 2e-6
