"""Kaiser-Bessel interpolation kernel math (pure jnp).

Matches the math of the reference kernels (`src/tron.cu:304-370`):
the Blair rational-polynomial I0 approximation, the beta shape parameter
(2.34 * J by default — the same constant IRT uses, `contrib/irt/kaiser_bessel.m`
— or the Beatty et al. formula), the windowed KB kernel, and its Fourier
transform with both the sin and sinh branches.

Everything here is shape-polymorphic, jit-safe, and branch-free (jnp.where),
so it vectorizes on the VPU and can be inlined into Pallas kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

# Numerator/denominator coefficients of the Blair & Edwards Chebyshev-derived
# rational approximation to I0(x) for |x| <= 15, as used by the reference
# (`src/tron.cu:304-321`) and by numpy's own i0 implementation.
_I0_NUM = (
    0.210580722890567e-22,
    0.380715242345326e-19,
    0.479440257548300e-16,
    0.435125971262668e-13,
    0.300931127112960e-10,
    0.160224679395361e-7,
    0.654858370096785e-5,
    0.202591084143397e-2,
    0.463076284721000e0,
    0.754337328948189e2,
    0.830792541809429e4,
    0.571661130563785e6,
    0.216415572361227e8,
    0.356644482244025e9,
    0.144048298227235e10,
)
_I0_DEN = (1.0, -0.307646912682801e4, 0.347626332405882e7, -0.144048298227235e10)


def besseli0(x: jnp.ndarray) -> jnp.ndarray:
    """Modified Bessel function I0 via rational polynomial (|x| <= 15).

    Accurate to ~1e-8 relative over the range used by KB kernels
    (beta <= ~15 for kernel widths <= 3.2 at the default shape).
    """
    z = x * x
    num = jnp.zeros_like(z) + _I0_NUM[0]
    for c in _I0_NUM[1:]:
        num = num * z + c
    den = jnp.zeros_like(z) + _I0_DEN[0]
    for c in _I0_DEN[1:]:
        den = den * z + c
    return -num / den


def kb_beta(kernwidth: float, gridos: float, beatty: bool = False) -> float:
    """KB shape parameter beta (`src/tron.cu:323-335`).

    Default: beta = 2.34 * J with J = 2*kernwidth (IRT's alpha=2.34*J).
    Beatty et al. 2005: beta = pi*sqrt((J/os)^2*(os-1/2)^2 - 0.8) with J the
    *full* kernel width.  (The reference's disabled BEATTY_BETA variant
    plugs in the half-width, `src/tron.cu:328-330`, giving a beta ~2.4x too
    small and ~3% interpolation error — a quirk we do not replicate.)
    """
    if beatty:
        a = 2.0 * kernwidth / gridos
        b = gridos - 0.5
        return float(jnp.pi) * float((a * a * b * b - 0.8) ** 0.5)
    return 2.34 * 2.0 * kernwidth


def kb_kernel(x: jnp.ndarray, kernwidth: float, beta: float) -> jnp.ndarray:
    """KB window 0.5*I0(beta*sqrt(1-(x/kw)^2))/kw for |x| < kw, else 0.

    (`src/tron.cu:338-349`.)  Branch-free: the sqrt argument is clamped so
    out-of-support lanes compute garbage that is then masked to zero.
    """
    r = x * (1.0 / kernwidth)
    inside = jnp.abs(r) < 1.0
    f = jnp.sqrt(jnp.clip(1.0 - r * r, 0.0, None))
    val = (0.5 / kernwidth) * besseli0(beta * f)
    return jnp.where(inside, val, 0.0)


def kb_hat(u: jnp.ndarray, kernwidth: float, beta: float) -> jnp.ndarray:
    """Fourier transform of the KB window (`src/tron.cu:351-370`).

    u is in units of the oversampled FOV: the deapodization weight at image
    pixel offset p (from center) on an n-point oversampled grid is
    kb_hat(p / n, ...).  Uses sin(z)/z for r^2 > beta^2 and sinh(z)/z for
    r^2 < beta^2, with the removable singularity at z == 0 handled exactly.
    """
    J = 2.0 * kernwidth
    r = jnp.pi * J * u
    q = r * r - beta * beta
    az = jnp.sqrt(jnp.abs(q))
    safe = jnp.where(az > 1e-12, az, 1.0)
    y_sin = jnp.sin(safe) / safe
    y_sinh = jnp.sinh(safe) / safe
    y = jnp.where(q > 0, y_sin, y_sinh)
    return jnp.where(az > 1e-12, y, 1.0)
