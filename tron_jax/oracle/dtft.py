"""Exact (slow) discrete-time Fourier transform oracle.

Plays the role the vendored Fessler IRT toolbox plays in the reference's
quality story (`contrib/irt/nufft.m:18-102` self-tests against dtft/dtft2_adj,
SURVEY.md §4): every fast NUFFT op is unit-tested against these O(N*M)
direct sums on small problems, and `dtft2_adjoint_chunked` scales the same
exact sum to full reference frame geometry (512-point readout, 204 spokes,
256^2 image — the whole-body case of `src/RUNME4_others_grid_slcmt.m:74-79`)
as jitted matmul chunks.

Convention (shared with tron_jax.nufft): image pixels live at centered
integer coordinates p, q in [-n/2, n/2) of an ``nos``-point oversampled
transform; a k-space sample at grid-unit frequency (kx, ky) is

    S(kx, ky) = sum_{q,p} img[..., q + n/2, p + n/2]
                  * exp(-2j*pi*(kx*p + ky*q) / nos)

which is exactly what centered-FFT-then-perfect-interpolation computes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _phase(n: int, nos: int, k: jnp.ndarray) -> jnp.ndarray:
    """exp(-2j pi k p / nos) for all centered pixel coords p; shape (M, n).

    fp32-exact at large |k*p|: the product is split as k = round(k) + frac so
    the integer part of k*p (exact in fp32 below 2^24) can be reduced mod nos
    before the 2*pi scaling — the naive fp32 path loses ~2.4e-5 rad of phase
    at |k*p| ~ 3e4 (512-readout geometry), this loses <1e-7.
    """
    p = (jnp.arange(n) - n // 2).astype(jnp.float32)
    k = k.astype(jnp.float32)
    k_hi = jnp.round(k)
    k_lo = k - k_hi
    prod_mod = jnp.mod(k_hi[:, None] * p[None, :], float(nos))  # exact ints
    prod_mod = jnp.mod(prod_mod + k_lo[:, None] * p[None, :], float(nos))
    ang = (-2.0 * jnp.pi / nos) * prod_mod
    return jnp.exp(1j * ang.astype(jnp.float32))


def dtft2(img: jnp.ndarray, kx: jnp.ndarray, ky: jnp.ndarray, nos: int) -> jnp.ndarray:
    """Exact forward transform. img: (..., n, n) [y, x]; kx, ky: (M,) in
    grid units of the nos-point transform. Returns (..., M) complex."""
    n = img.shape[-1]
    ex = _phase(n, nos, kx)  # (M, nx)
    ey = _phase(n, nos, ky)  # (M, ny)
    tmp = jnp.einsum("...yx,mx->...ym", img.astype(jnp.complex64), ex, precision=_HI)
    return jnp.einsum("...ym,my->...m", tmp, ey, precision=_HI)


def dtft2_adjoint(
    samples: jnp.ndarray, kx: jnp.ndarray, ky: jnp.ndarray, n: int, nos: int
) -> jnp.ndarray:
    """Exact adjoint: (..., M) samples -> (..., n, n) image [y, x]."""
    ex = jnp.conj(_phase(n, nos, kx))  # (M, nx)
    ey = jnp.conj(_phase(n, nos, ky))  # (M, ny)
    tmp = jnp.einsum("...m,my->...ym", samples.astype(jnp.complex64), ey, precision=_HI)
    return jnp.einsum("...ym,mx->...yx", tmp, ex, precision=_HI)


def dtft2_adjoint_chunked(
    samples: jnp.ndarray,
    kx: jnp.ndarray,
    ky: jnp.ndarray,
    n: int,
    nos: int,
    chunk: int = 8192,
) -> jnp.ndarray:
    """Exact adjoint at reference scale: lax.scan over sample chunks so the
    (M, n) phase operands and the (..., n, M) intermediate never materialize
    at full M.  At whole-body frame geometry (M = 204*512 samples, n = 256,
    6 coils) this is ~3e11 flops of HIGHEST-precision matmul — seconds on a
    chip, feasible on CPU — where the one-shot `dtft2_adjoint` would need a
    ~5 GB intermediate.  Zero-padded tail samples contribute exactly zero."""
    m = samples.shape[-1]
    batch = samples.shape[:-1]
    nchunks = -(-m // chunk)
    pad = nchunks * chunk - m
    s = jnp.pad(samples.astype(jnp.complex64), [(0, 0)] * len(batch) + [(0, pad)])
    kxp = jnp.pad(kx.astype(jnp.float32), (0, pad))
    kyp = jnp.pad(ky.astype(jnp.float32), (0, pad))
    s = jnp.moveaxis(s.reshape(batch + (nchunks, chunk)), -2, 0)
    kxp = kxp.reshape(nchunks, chunk)
    kyp = kyp.reshape(nchunks, chunk)

    def body(acc, inp):
        sc, kxc, kyc = inp
        return acc + dtft2_adjoint(sc, kxc, kyc, n, nos), None

    acc0 = jnp.zeros(batch + (n, n), jnp.complex64)
    out, _ = jax.lax.scan(body, acc0, (s, kxp, kyp))
    return out


def oracle_adjoint_recon(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    cfg,
    n: int,
    nro: int,
    chunk: int = 8192,
) -> jnp.ndarray:
    """Exact adjoint recon of radial data under the fast path's contract.

    One canonical implementation of the weighting/scaling recipe every
    oracle comparison shares (RUNME2/RUNME4-role scoring, the full-geometry
    parity test, dataset_metrics --oracle): per-cfg SDC (Ram-Lak by
    default), readout index 0 zeroed (the gridder's |radius| < n edge mask
    excludes it), exact chunked DTFT adjoint, 1/(nro*npe) scale
    (src/tron.cu:532).

    data: (..., npe, nro) complex samples; angles: (npe,) spoke angles.
    Returns (..., n, n) complex coil images (no combine).  jit-safe with
    n/nro/chunk static.
    """
    from tron_jax.nufft import sdc_weights

    npe = int(angles.shape[0])
    kr = (jnp.arange(nro).astype(jnp.float32) / nro - 0.5) * nro
    kx = (kr[None, :] * jnp.cos(angles)[:, None]).reshape(-1)
    ky = (kr[None, :] * jnp.sin(angles)[:, None]).reshape(-1)
    d = jnp.asarray(data)
    wd = d * sdc_weights(cfg, nro, npe).astype(d.dtype)
    wd = wd.at[..., 0].set(0)
    batch = d.shape[:-2]
    img = dtft2_adjoint_chunked(wd.reshape(batch + (-1,)), kx, ky, n, nro, chunk)
    return img / (nro * npe)
