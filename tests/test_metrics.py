"""Metrics layer tests (rmse/lmse/nmse/ssim ~ the reference's MATLAB
metric scripts)."""

import numpy as np

from tron_jax.metrics import lmse, lmsediff, nmse, nrmse, rmse, ssim


def test_rmse_nmse_basic(rng):
    a = rng.standard_normal((8, 8))
    assert rmse(a, a) == 0
    b = a + 1.0
    assert np.isclose(rmse(a, b), 1.0)
    assert np.isclose(nmse(a, a), 0.0)
    assert np.isclose(nrmse(2 * a, a), np.linalg.norm(a) / np.linalg.norm(a))


def test_lmse_scale_invariant(rng):
    a = (rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16)))
    for s in [2.0, -0.5, 1j, 3 - 4j]:
        assert lmse(s * a, a) < 1e-12
    d = lmsediff(2.0 * a, a)
    assert np.abs(d).max() < 1e-6


def test_ssim_identity_and_noise(rng):
    img = rng.random((64, 64))
    assert ssim(img, img) > 0.999
    noisy = img + 0.5 * rng.standard_normal((64, 64))
    s = ssim(noisy, img)
    assert 0 < s < 0.9


def test_ssim_matches_known_range():
    # smooth gradient vs slightly corrupted copy: high but < 1
    x = np.linspace(0, 1, 64)
    img = np.outer(x, x)
    pert = img + 0.01 * np.sin(20 * img)
    assert 0.8 < ssim(pert, img) <= 1.0


def test_viz_writes_pngs(tmp_path, rng):
    from tron_jax.viz import compare, mosaic, rimp

    stack = rng.random((5, 16, 16))
    p1 = mosaic(stack, str(tmp_path / "m.png"))
    img = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    p2 = rimp(img, str(tmp_path / "r.png"))
    p3 = compare(img, img * 1.1, str(tmp_path / "c.png"))
    for p in (p1, p2, p3):
        data = open(p, "rb").read(8)
        assert data[:4] == b"\x89PNG"


def test_raview(tmp_path, rng):
    from tron_jax.io import ra_write
    from tron_jax.viz import raview

    img = (rng.standard_normal((1, 1, 16, 16, 3)) + 0j).astype(np.complex64)
    p = tmp_path / "v.ra"
    ra_write(img, p)
    out = raview(str(p))
    assert open(out, "rb").read(4) == b"\x89PNG"
