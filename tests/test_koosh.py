"""3D stack-of-stars (-3) tests: kz is a Cartesian FFT axis decoupled from
the in-plane radial NUFFT, so forward-then-adjoint recovers each slice."""

import numpy as np

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.phantom import shepp_logan
from tron_jax.recon import recon_radial2d
from tests.conftest import lmse


def _gaussian(n):
    c = (np.arange(n) - n // 2) / (n / 2)
    X, Y = np.meshgrid(c, c)
    return np.exp(-((X - 0.1) ** 2 + (Y + 0.2) ** 2) / 0.1).astype(np.complex64)


def test_stack_of_stars_roundtrip():
    n, nzs = 32, 4
    # distinct per-slice images: scaled smooth blobs (sharp phantoms at tiny
    # n are dominated by Gibbs error, which is not what this test measures)
    img = np.stack([_gaussian(n) * (z + 1) for z in range(nzs)], axis=-1)
    # img is [y, x, z]; the 5-D .ra layout slots are (nc, nt, nx, ny, nz)
    vol = img.transpose(1, 0, 2)[None, None]
    cfg_f = ReconConfig(koosh=True, angle_scheme=AngleScheme.LINEAR_HALF, sdc="ideal")
    data = recon_radial2d(vol.astype(np.complex64), cfg_f)
    # forward: (npe2, nc, nt, npe1, nro)
    assert data.shape[0] == nzs and data.shape[-1] == 2 * n

    # adjoint expects (nc, nt, nro, npe1, npe2)
    d5 = np.transpose(data, (1, 2, 4, 3, 0))
    cfg_a = ReconConfig(
        koosh=True, adjoint=True, angle_scheme=AngleScheme.LINEAR_HALF, sdc="ideal"
    )
    rec = recon_radial2d(np.ascontiguousarray(d5), cfg_a)  # (npe2, nt, n, n)
    assert rec.shape == (nzs, 1, n, n)

    for z in range(nzs):
        err = lmse(rec[z, 0], img[..., z])
        assert err < 0.4, f"slice {z} lmse={err:.3f}"
    # slice amplitudes must scale ~linearly (kz decoupling works)
    mags = [np.abs(rec[z, 0]).mean() for z in range(nzs)]
    ratios = np.array(mags) / mags[0]
    np.testing.assert_allclose(ratios, np.arange(1, nzs + 1), rtol=0.15)


def test_stack_of_stars_npe2_8_nt2():
    """Scale case: 8 kz slices x 2 repetitions through the single-jit
    device path (no per-slice host loop)."""
    n, nzs, nt = 32, 8, 2
    img = np.stack(
        [_gaussian(n) * (1 + 0.25 * z) for z in range(nzs)], axis=-1
    )  # (y, x, z)
    vol = np.stack([img, 2 * img], axis=0).transpose(0, 2, 1, 3)[:, None]
    # vol: (nt, 1, nx, ny, nz) -> .ra slots (nc=1? no: nc first)
    vol = vol[None].reshape(1, nt, n, n, nzs)  # (nc=1, nt, nx, ny, nz)
    cfg_f = ReconConfig(koosh=True, angle_scheme=AngleScheme.LINEAR_HALF, sdc="ideal")
    data = recon_radial2d(vol.astype(np.complex64), cfg_f)
    assert data.shape == (nzs, 1, nt, data.shape[3], 2 * n)

    d5 = np.transpose(data, (1, 2, 4, 3, 0))
    cfg_a = ReconConfig(
        koosh=True, adjoint=True, angle_scheme=AngleScheme.LINEAR_HALF, sdc="ideal"
    )
    rec = recon_radial2d(np.ascontiguousarray(d5), cfg_a)
    assert rec.shape == (nzs, nt, n, n)
    for z in range(0, nzs, 3):
        err = lmse(rec[z, 0], img[..., z])
        assert err < 0.4, f"slice {z} lmse={err:.3f}"
    # the second repetition is 2x the first (linearity end-to-end)
    np.testing.assert_allclose(rec[:, 1], 2 * rec[:, 0], rtol=1e-3, atol=1e-5)


def test_stack_of_stars_sharded_matches_local(rng):
    """-3 --shard: kz slices sharded over the 8 virtual devices (incl. a
    slice count that does not divide the mesh) must match the single-device
    koosh recon."""
    import jax

    from tron_jax.parallel import make_mesh, recon_stack_of_stars_sharded

    n, nzs, nc = 32, 6, 2
    nro, npe1 = 2 * n, 32
    d5 = (
        rng.standard_normal((nc, 1, nro, npe1, nzs))
        + 1j * rng.standard_normal((nc, 1, nro, npe1, nzs))
    ).astype(np.complex64)
    cfg = ReconConfig(
        koosh=True, adjoint=True, angle_scheme=AngleScheme.LINEAR_HALF
    )
    want = recon_radial2d(d5, cfg)
    mesh = make_mesh(n_frame=8, n_coil=1, devices=jax.devices())
    got = np.asarray(recon_stack_of_stars_sharded(d5, cfg, mesh))
    assert got.shape == want.shape == (nzs, 1, n, n)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_koosh_streaming_matches_in_memory(tmp_path, rng):
    """-3 --stream driver: npe1-blocked profile windows at all kz encodings
    (io.native.ra_read_profiles_stack) must equal the in-memory koosh recon
    across multiple frame windows incl. the realigned tail, with the
    golden-angle skip0 threaded so absolute profile indices survive the
    windowing."""
    from tron_jax.io import ra_write
    from tron_jax.recon import recon_koosh_streaming

    nc, nt, nro, npe1, npe2 = 2, 1, 32, 120, 3
    d5 = (
        rng.standard_normal((nc, nt, nro, npe1, npe2))
        + 1j * rng.standard_normal((nc, nt, nro, npe1, npe2))
    ).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d5, p)
    cfg = ReconConfig(
        koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.5
    )
    want = recon_radial2d(d5, cfg)  # (npe2*nzi, nt, n, n), nzi=7
    got = recon_koosh_streaming(p, cfg, batch_frames=3)  # windows 0,3,4
    assert got.shape == want.shape == (npe2 * 7, nt, 16, 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_koosh_streaming_kz_blocks(tmp_path, rng, monkeypatch):
    """Several kz-slice blocks per profile window (npe2 > block size, with
    the realigned overlapping tail block) — forced via TRON_KOOSH_BATCH=1
    so nb = 8 < npe2 = 12."""
    from tron_jax.io import ra_write
    from tron_jax.recon import recon_koosh_streaming

    monkeypatch.setenv("TRON_KOOSH_BATCH", "1")
    nc, nt, nro, npe1, npe2 = 2, 2, 32, 32, 12
    d5 = (
        rng.standard_normal((nc, nt, nro, npe1, npe2))
        + 1j * rng.standard_normal((nc, nt, nro, npe1, npe2))
    ).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d5, p)
    cfg = ReconConfig(
        koosh=True, adjoint=True, golden_angle=True, data_undersamp=0.5
    )
    want = recon_radial2d(d5, cfg)  # nzi = 2
    got = recon_koosh_streaming(p, cfg, batch_frames=8)
    assert got.shape == want.shape == (npe2 * 2, nt, 16, 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
