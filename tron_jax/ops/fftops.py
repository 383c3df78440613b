"""Centered FFTs, crop/pad, deapodization.

Equivalents of the reference's fftshift/cufft/crop/pad/deapodkernel chain
(`src/tron.cu:159-220, 390-457`), in the obvious jnp forms —
XLA fuses the shifts and the deapod multiply into the surrounding ops, so
there is nothing to hand-schedule here.

Conventions: images and k-space grids are (..., ny, nx), centered at index
n//2 on both axes.  The inverse transform is *unnormalized* (a plain sum,
like cuFFT's CUFFT_INVERSE) so amplitudes match the reference pipelines.
"""

from __future__ import annotations

import jax.numpy as jnp

from tron_jax.kernels.kb import kb_hat


def centered_fft2(img: jnp.ndarray) -> jnp.ndarray:
    """Centered image -> centered k-space, unnormalized forward DFT."""
    axes = (-2, -1)
    return jnp.fft.fftshift(
        jnp.fft.fft2(jnp.fft.ifftshift(img, axes=axes), axes=axes), axes=axes
    )


def centered_ifft2_unnormalized(kgrid: jnp.ndarray) -> jnp.ndarray:
    """Centered k-space -> centered image, unnormalized inverse DFT
    (cuFFT INVERSE semantics: no 1/N^2 factor; `src/tron.cu:632`)."""
    axes = (-2, -1)
    n = kgrid.shape[-1] * kgrid.shape[-2]
    out = jnp.fft.ifft2(jnp.fft.ifftshift(kgrid, axes=axes), axes=axes)
    return jnp.fft.fftshift(out, axes=axes) * n


def crop_center(img: jnp.ndarray, n: int) -> jnp.ndarray:
    """Center-crop the trailing two axes to (n, n) (`src/tron.cu:418-431`)."""
    nsrc = img.shape[-1]
    w = (nsrc - n) // 2
    return img[..., w : w + n, w : w + n]


def pad_center(img: jnp.ndarray, nos: int) -> jnp.ndarray:
    """Center zero-pad the trailing two axes to (nos, nos).

    (The reference `pad` at src/tron.cu:435-457 drops row/col 0 via an
    off-by-one boundary test; that is a documented bug we do not replicate.)
    """
    n = img.shape[-1]
    w = (nos - n) // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(w, nos - n - w), (w, nos - n - w)]
    return jnp.pad(img, pad)


def deapod_weights(n: int, nxos: int, kernwidth: float, beta: float) -> jnp.ndarray:
    """Separable deapodization weights for an (n, n) block of an nxos-unit
    transform: w[p] = kb_hat((p - n//2)/nxos) per axis (`src/tron.cu:390-402`,
    where sigma folds the crop so the argument is always offset/nxos)."""
    p = (jnp.arange(n) - n // 2).astype(jnp.float32)
    w = kb_hat(p * (1.0 / nxos), kernwidth, beta)
    return w[:, None] * w[None, :]


def deapodize(img: jnp.ndarray, nxos: int, kernwidth: float, beta: float) -> jnp.ndarray:
    """Divide out the KB kernel's image-domain rolloff. Where the weight is
    <= 0 the pixel passes through, as in the reference (`src/tron.cu:400`)."""
    w = deapod_weights(img.shape[-1], nxos, kernwidth, beta)
    return jnp.where(w > 0, img / w.astype(img.dtype), img)

