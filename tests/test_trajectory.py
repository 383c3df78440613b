"""Trajectory geometry tests: golden-angle sequence, Ram-Lak ramp, framing."""

import numpy as np

from tron_jax.config import PHI, AngleScheme, ReconConfig
from tron_jax.trajectory import modang, ramlak_sdc, sample_radii, spoke_angles, grid_radius_to_ro


def test_phi_constant():
    # PHI = 1.9416089796736116 rad = 111.246 deg (reference src/tron.cu:90)
    assert np.isclose(PHI, 1.9416089796736116, atol=1e-12)
    assert np.isclose(np.rad2deg(PHI), 111.24611, atol=1e-4)


def test_modang_range():
    x = np.array([-7.0, -np.pi, 0.0, np.pi, 9.0, 100.0], dtype=np.float32)
    y = np.asarray(modang(x))
    assert np.all((y >= 0) & (y < 2 * np.pi))
    np.testing.assert_allclose(np.mod(y - x, 2 * np.pi), 0, atol=1e-4)


def test_golden_angles_with_skip():
    a = np.asarray(spoke_angles(8, AngleScheme.GOLDEN, skip=3))
    want = np.mod(PHI * (np.arange(8) + 3), 2 * np.pi)
    np.testing.assert_allclose(a, want, rtol=1e-6, atol=1e-5)


def test_linear_schemes():
    n = 16
    full = np.asarray(spoke_angles(n, AngleScheme.LINEAR_FULL))
    half = np.asarray(spoke_angles(n, AngleScheme.LINEAR_HALF))
    np.testing.assert_allclose(full, np.arange(n) * 2 * np.pi / n + np.pi / 2, rtol=1e-6)
    np.testing.assert_allclose(half, np.arange(n) * np.pi / n, rtol=1e-6)


def test_ramlak_values():
    nro, npe = 8, 4
    sdc = np.asarray(ramlak_sdc(nro, npe))
    a = (2 - 2 / npe) / nro
    b = 1 / npe
    want = a * np.abs(np.arange(nro) - nro // 2) + b
    np.testing.assert_allclose(sdc, want, rtol=1e-6)
    assert np.isclose(sdc[nro // 2], 1 / npe)


def test_sample_radii_integer_when_nxos_eq_nro():
    r = np.asarray(sample_radii(16, 16))
    np.testing.assert_allclose(r, np.arange(16) - 8)
    ro = np.asarray(grid_radius_to_ro(r, 16, 16))
    np.testing.assert_array_equal(ro, np.arange(16))


def test_frame_geometry_whole_body():
    # whole-body: nro=512, npe1=20271, -u 0.4 -d 21 -> 956 frames of 204
    cfg = ReconConfig(data_undersamp=0.4, prof_slide=21)
    work, slide, nz = cfg.frame_geometry(512, 20271)
    assert work == 204
    assert slide == 21
    assert nz == 956


def test_frame_geometry_defaults():
    cfg = ReconConfig()
    work, slide, nz = cfg.frame_geometry(64, 64)
    assert (work, slide, nz) == (64, 64, 1)
    cfg = ReconConfig(prof_slide=32)
    work, slide, nz = cfg.frame_geometry(64, 128)
    assert (work, slide, nz) == (64, 32, 3)
