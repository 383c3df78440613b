"""KB kernel math vs scipy and analytic identities."""

import numpy as np
import scipy.special

from tron_jax.kernels import besseli0, kb_beta, kb_kernel, kb_hat


def test_besseli0_vs_scipy():
    x = np.linspace(0, 15, 301, dtype=np.float32)
    got = np.asarray(besseli0(x))
    want = scipy.special.i0(x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_beta_default_and_beatty():
    assert np.isclose(kb_beta(2.0, 2.0), 2.34 * 4.0)
    a, b = 2.0 * 2.0 / 2.0, 2.0 - 0.5  # J/os with J = 2*kw (Beatty 2005)
    assert np.isclose(kb_beta(2.0, 2.0, beatty=True), np.pi * np.sqrt(a * a * b * b - 0.8))


def test_kb_kernel_support_and_shape():
    kw = 2.0
    beta = kb_beta(kw, 2.0)
    x = np.linspace(-3, 3, 601, dtype=np.float32)
    w = np.asarray(kb_kernel(x, kw, beta))
    assert np.all(w[np.abs(x) >= kw] == 0)
    assert np.all(w[np.abs(x) < kw] >= 0)
    # peak at center: 0.5*I0(beta)/kw
    assert np.isclose(w[300], 0.5 * scipy.special.i0(beta) / kw, rtol=1e-5)
    # even symmetry
    np.testing.assert_allclose(w, w[::-1], rtol=0, atol=1e-6)


def test_kb_hat_matches_continuous_ft():
    """kb_hat should be proportional to the continuous FT of kb_kernel."""
    kw, gridos = 2.0, 2.0
    beta = kb_beta(kw, gridos)
    # numerical FT of the window on a fine grid
    dx = 1e-3
    x = np.arange(-kw, kw, dx, dtype=np.float64)
    w = np.asarray(kb_kernel(x.astype(np.float32), kw, beta)).astype(np.float64)
    for u in [0.0, 0.05, 0.1, 0.2, 0.25]:
        num = np.sum(w * np.cos(2 * np.pi * u * x)) * dx
        ana = float(kb_hat(np.float32(u), kw, beta))
        ana0 = float(kb_hat(np.float32(0.0), kw, beta))
        num0 = np.sum(w) * dx
        # proportionality: ratios must match
        np.testing.assert_allclose(num / num0, ana / ana0, rtol=2e-4)


def test_kb_hat_branches_continuous():
    kw = 2.0
    beta = kb_beta(kw, 2.0)
    # crossing point r == beta: u* = beta / (pi*J)
    ustar = beta / (np.pi * 2 * kw)
    u = np.array([ustar - 1e-4, ustar, ustar + 1e-4], dtype=np.float32)
    y = np.asarray(kb_hat(u, kw, beta))
    assert np.all(np.isfinite(y))
    # slope near the branch point is ~40/unit-u; 2e-4 apart => ~0.008
    assert abs(y[0] - y[2]) < 0.02
