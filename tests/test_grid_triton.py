"""The Triton gridding kernel vs the plain XLA gridder, in the Pallas
interpreter (the same kernel compiles for the GPU; tests/test_gpu_parity.py
compares it there at full width)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tron_jax.config import AngleScheme
from tron_jax.kernels.kb import kb_beta
from tron_jax.ops import grid_triton
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.grid import grid_radial2d
from tron_jax.trajectory import spoke_angles
from tests.conftest import nrmse


def _case(rng, C, npe, nro, scheme=AngleScheme.GOLDEN, skip=5):
    data = (
        rng.standard_normal((C, npe, nro)) + 1j * rng.standard_normal((C, npe, nro))
    ).astype(np.complex64)
    return jnp.asarray(data), jnp.asarray(spoke_angles(npe, scheme, skip))


def _kernel(data, angles, nxos, kw=2.0, gridos=2.0, **kwargs):
    return np.asarray(
        grid_triton.grid_radial2d_triton(
            data, angles, nxos, kw, kb_beta(kw, gridos), interpret=True, **kwargs
        )
    )


def _plain(data, angles, nxos, kw=2.0, gridos=2.0, **kwargs):
    return np.asarray(
        grid_radial2d(data, angles, nxos, kw, kb_beta(kw, gridos), **kwargs)
    )


@pytest.mark.parametrize(
    "C,npe,nxos", [(2, 12, 64), (1, 23, 64), (1, 9, 128), (2, 7, 96), (3, 5, 48)]
)
def test_kernel_matches_plain(rng, C, npe, nxos):
    data, angles = _case(rng, C, npe, nxos)
    err = nrmse(_kernel(data, angles, nxos), _plain(data, angles, nxos))
    assert err < 1e-5, f"kernel vs plain nrmse={err:.2e}"


@pytest.mark.parametrize(
    "scheme", [AngleScheme.LINEAR_HALF, AngleScheme.LINEAR_FULL]
)
def test_linear_angles(rng, scheme):
    """Linear spokes include the axis-aligned angles 0 and pi/2, where one
    slab of the chord test is degenerate."""
    data, angles = _case(rng, 1, 16, 64, scheme=scheme, skip=0)
    assert nrmse(_kernel(data, angles, 64), _plain(data, angles, 64)) < 1e-5


@pytest.mark.parametrize("precision", ["fast", "accurate"])
def test_precision_modes(rng, precision):
    """Both modes name a dot algorithm; the interpreter runs both in fp32."""
    data, angles = _case(rng, 2, 8, 64)
    got = _kernel(data, angles, 64, precision=precision)
    assert nrmse(got, _plain(data, angles, 64)) < 1e-5


def test_2d_input(rng):
    data, angles = _case(rng, 1, 8, 64)
    got = _kernel(data[0], angles, 64)
    assert got.shape == (64, 64)
    assert nrmse(got, _plain(data[0], angles, 64)) < 1e-5


def test_batch_dims(rng):
    """Leading dims flatten into channel planes and come back."""
    d = (rng.standard_normal((2, 3, 6, 32)) +
         1j * rng.standard_normal((2, 3, 6, 32))).astype(np.complex64)
    angles = spoke_angles(6, AngleScheme.GOLDEN, 1)
    got = _kernel(jnp.asarray(d), angles, 32)
    assert got.shape == (2, 3, 32, 32)
    assert nrmse(got, _plain(jnp.asarray(d), angles, 32)) < 1e-5


@pytest.mark.parametrize("nxos", [16, 24, 40])
def test_grid_not_a_multiple_of_the_tile(rng, nxos):
    """The grid pads to whole tiles and is cropped back."""
    data, angles = _case(rng, 1, 6, nxos)
    assert nrmse(_kernel(data, angles, nxos), _plain(data, angles, nxos)) < 1e-5


@pytest.mark.parametrize("cb", [1, 2, 8])
def test_channel_groups(rng, cb, monkeypatch):
    """Channel planes split into groups of at most CHANNEL_BLOCK per
    program, padded with zero planes when they do not divide."""
    monkeypatch.setattr(grid_triton, "CHANNEL_BLOCK", cb)
    data, angles = _case(rng, 3, 6, 32)
    assert nrmse(_kernel(data, angles, 32), _plain(data, angles, 32)) < 1e-5


def test_vmap_over_frames(rng):
    """lax.map over frame blocks vmaps the kernel (a batched grid axis);
    it must equal the per-frame loop."""
    F, C, npe, nro = 3, 2, 8, 32
    data = (rng.standard_normal((F, C, npe, nro)) +
            1j * rng.standard_normal((F, C, npe, nro))).astype(np.complex64)
    skips = jnp.asarray([0.0, 5.0, 11.0])

    def one(d, skip):
        ang = spoke_angles(npe, AngleScheme.GOLDEN, skip)
        return grid_triton.grid_radial2d_triton(
            d, ang, nro, 2.0, kb_beta(2.0, 2.0), interpret=True
        )

    got = np.asarray(jax.vmap(one)(jnp.asarray(data), skips))
    for f in range(F):
        want = np.asarray(one(jnp.asarray(data[f]), skips[f]))
        assert nrmse(got[f], want) < 1e-6


@pytest.mark.parametrize("gridos", [1.5, 2.5])
def test_nondefault_gridos(rng, gridos):
    """gridos != 2: readouts are trunc-resampled onto the integer grid
    radii (src/tron.cu:517) before the kernel."""
    nro = 64
    nxos = int((nro // 2) * gridos)
    data, angles = _case(rng, 1, 7, nro)
    got = _kernel(data, angles, nxos, gridos=gridos)
    want = _plain(data, angles, nxos, gridos=gridos)
    assert nrmse(got, want) < 1e-5


@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_exact_lattice_matches_plain(rng, gridos):
    """exact=True grids raw readout rows at their exact radii, like the
    plain raw_rows gridder; at gridos 2 it equals the default path."""
    nro = 64
    nxos = int((nro // 2) * gridos)
    data, angles = _case(rng, 1, 6, nro)
    data = data.at[..., 0].set(0)    # readout 0 is never gridded
    got = _kernel(data, angles, nxos, gridos=gridos, exact=True)
    want = _plain(data, angles, nxos, gridos=gridos, raw_rows=True)
    assert nrmse(got, want) < 1e-5
    if gridos == 2.0:
        assert nrmse(got, _kernel(data, angles, nxos)) < 1e-6


@pytest.mark.parametrize("gridos", [1.5, 2.0, 2.5])
def test_exact_pair_adjointness(rng, gridos):
    """Dot test: the exact-lattice kernel is the transpose of the clip-mode
    gather degrid (the CGNR pair contract)."""
    nro, npe = 64, 5
    nxos = int((nro // 2) * gridos)
    beta = kb_beta(2.0, gridos)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.GOLDEN, 2))
    x = (rng.standard_normal((1, nxos, nxos))
         + 1j * rng.standard_normal((1, nxos, nxos))).astype(np.complex64)
    y = (rng.standard_normal((1, npe, nro))
         + 1j * rng.standard_normal((1, npe, nro))).astype(np.complex64)
    y[..., 0] = 0
    Ax = degrid_radial2d(jnp.asarray(x), angles, nro, 2.0, beta, wrap=False)
    AHy = grid_triton.grid_radial2d_triton(
        jnp.asarray(y), angles, nxos, 2.0, beta, exact=True, interpret=True
    ) * (nxos * npe)  # undo the gridder's reference 1/(nxos*npe) scale
    lhs = complex(jnp.vdot(jnp.asarray(y), Ax))
    rhs = complex(jnp.vdot(AHy, jnp.asarray(x)))
    assert abs(lhs - rhs) / abs(rhs) < 1e-4


@pytest.mark.parametrize("kw", [1.5, 3.0])
def test_kernel_widths(rng, kw):
    data, angles = _case(rng, 1, 6, 64)
    got = _kernel(data, angles, 64, kw=kw)
    assert nrmse(got, _plain(data, angles, 64, kw=kw)) < 1e-5


@pytest.mark.parametrize(
    "tile,kw,row_scale,want",
    [(16, 2.0, 1.0, 32), (32, 2.0, 1.0, 64), (16, 2.0, 0.75, 64),
     (16, 3.0, 1.25, 32), (16, 3.0, 1.0, 64)],
)
def test_window_rows(tile, kw, row_scale, want):
    """A window holds the longest chord through the grown tile, in rows."""
    win = grid_triton.window_rows(tile, kw, row_scale)
    assert win == want
    diag = np.sqrt(2.0) * (tile - 1 + 2 * (kw + grid_triton._MARGIN))
    assert win >= diag / row_scale + 2


@pytest.mark.parametrize("skip", [0, 7])
def test_hit_tables_cover_every_contribution(skip):
    """Every (tile, spoke) pair whose KB footprint touches the tile is in
    the tile's hit list, and its window covers every contributing row."""
    nxos, tile, kw, npe = 64, 16, 2.0, 24
    ntiles, h, hr = nxos // tile, nxos // 2, nxos // 2
    win = grid_triton.window_rows(tile, kw, 1.0)
    angles = spoke_angles(npe, AngleScheme.GOLDEN, skip)
    hits, w0, cnt = (np.asarray(a) for a in grid_triton._hit_tables(
        angles, ntiles, tile, h, kw, nxos, hr, 1.0, win))
    ang = np.asarray(angles)
    r = np.arange(nxos) - hr
    for t in range(ntiles * ntiles):
        i, j = divmod(t, ntiles)
        ys = np.arange(i * tile, (i + 1) * tile) - h
        xs = np.arange(j * tile, (j + 1) * tile) - h
        listed = dict(zip(hits[t, :cnt[t]], w0[t, :cnt[t]]))
        for p in range(npe):
            px = r * np.cos(ang[p])
            py = r * np.sin(ang[p])
            near = (
                (np.abs(px[:, None] - xs[None, :]) < kw).any(1)
                & (np.abs(py[:, None] - ys[None, :]) < kw).any(1)
            )
            rows = np.nonzero(near[1:])[0] + 1   # row 0 is masked out
            if rows.size == 0:
                continue
            assert p in listed, (t, p)
            assert listed[p] <= rows.min() and rows.max() < listed[p] + win


def test_recon_frames_through_the_kernel(rng):
    """recon_frames with backend='pallas' (interpreted) equals the plain
    backend, direct and incremental."""
    import dataclasses

    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_frames, recon_frames_incremental

    nro, npe1, work, slide, nz = 32, 20, 12, 4, 3
    d = jnp.asarray((rng.standard_normal((2, npe1, nro)) +
                     1j * rng.standard_normal((2, npe1, nro))).astype(np.complex64))
    cfg = ReconConfig(golden_angle=True, adjoint=True, backend="jnp")
    cfg_k = dataclasses.replace(cfg, backend="pallas", interpret=True)
    want = np.asarray(recon_frames(d, cfg, work, slide, nz))
    assert nrmse(np.asarray(recon_frames(d, cfg_k, work, slide, nz)), want) < 1e-5
    inc = np.asarray(recon_frames_incremental(d, cfg_k, work, slide, nz))
    assert nrmse(inc, want) < 1e-5
