"""NUFFT operator pipelines: adjoint (gridding recon) and forward (degrid).

These are jit-able pure functions chaining the ops, mirroring the reference
host pipelines:

  adjoint  (`src/tron.cu:623-637`):
      precompensate -> grid -> centered unnormalized IFFT -> crop -> deapod
  forward  (`src/tron.cu:639-649`):
      pad -> deapod -> centered FFT -> degrid

Shapes: radial data is (..., npe, nro); images are (..., n, n) with n =
nro // 2 (adjoint) and k-space grids are (nxos, nxos), nxos = n * gridos.
Angles are passed explicitly (see trajectory.spoke_angles) so the pipelines
are scheme-agnostic and vmap over sliding-window frames (where the golden-
angle skip offset is a traced value).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tron_jax.config import ReconConfig
from tron_jax.kernels.kb import kb_beta
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.fftops import (
    centered_fft2,
    centered_ifft2_unnormalized,
    crop_center,
    deapodize,
    pad_center,
)
from tron_jax.ops.grid import grid_radial2d
from tron_jax.trajectory import ideal_sdc, ramlak_sdc


def sdc_weights(cfg: ReconConfig, nro: int, npe: int) -> jnp.ndarray:
    """Density-compensation weights per cfg.sdc."""
    if cfg.sdc == "ideal":
        return ideal_sdc(nro, npe)
    return ramlak_sdc(nro, npe)


def grid_backend(cfg: ReconConfig, exact: bool = False):
    """The one choice point of the adjoint gridder, keyed on
    jax.default_backend(): "auto" takes the Triton kernel on a GPU and the
    plain XLA gridder on the CPU, and refuses any other platform.
    "pallas" off the GPU runs only with cfg.interpret (the CPU tests).

    Returns gridw(data (..., npe, nro), angles, nxos, kernwidth, beta) ->
    (..., nxos, nxos).  ``exact`` grids every readout at its exact radius
    (see nufft_adjoint_exact) instead of the reference's trunc-resample."""
    platform = jax.default_backend()
    backend = cfg.backend
    if backend == "auto":
        if platform == "gpu":
            backend = "pallas"
        elif platform == "cpu":
            backend = "jnp"
        else:
            raise RuntimeError(f"no gridder for the {platform!r} platform")
    if backend == "pallas":
        if platform != "gpu" and not cfg.interpret:
            raise RuntimeError(
                "backend='pallas' is the Triton kernel and needs a GPU "
                f"(platform is {platform!r}); set interpret=True to run it "
                "in the Pallas interpreter"
            )
        from tron_jax.ops.grid_triton import grid_radial2d_triton

        return functools.partial(
            grid_radial2d_triton, precision=cfg.precision, exact=exact,
            interpret=cfg.interpret,
        )
    if backend == "jnp":
        return functools.partial(
            grid_radial2d, pe_chunk=cfg.pe_chunk, raw_rows=exact
        )
    raise ValueError(f"unknown backend {cfg.backend!r}")


def nufft_adjoint(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    cfg: ReconConfig,
    apply_sdc: bool = True,
) -> jnp.ndarray:
    """Radial samples (..., npe, nro) -> coil images (..., n, n)."""
    npe, nro = data.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)

    if apply_sdc:
        data = data * sdc_weights(cfg, nro, npe).astype(data.dtype)
    kgrid = grid_backend(cfg)(data, angles, nxos, cfg.kernwidth, beta)
    return _adjoint_epilogue(kgrid, n, cfg, beta)


def _adjoint_epilogue(kgrid, n, cfg, beta):
    """Centered unnormalized IFFT (cuFFT on the GPU) + crop + deapod."""
    nxos = kgrid.shape[-1]
    img = centered_ifft2_unnormalized(kgrid)
    img = crop_center(img, n)
    if cfg.deapodize:
        img = deapodize(img, nxos, cfg.kernwidth, beta)
    return img


def nufft_adjoint_exact(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    cfg: ReconConfig,
) -> jnp.ndarray:
    """Exact-lattice adjoint: grids every readout at its exact radius
    instead of the reference's trunc-resample (`src/tron.cu:517`), making
    it the precise adjoint of the forward degrid at ANY gridos — the
    A^H the CGNR operator pair needs when gridos != 2 (identical to
    nufft_adjoint(apply_sdc=False) at the default gridos=2).  No SDC is
    applied (the solver supplies its own weights).

    Convention: readout 0 (radius -nxos/2, one sample per spoke at the
    unpaired Nyquist edge) is NEVER gridded, as in the default adjoint's
    radius map; cgnr_radial2d additionally weights it out of the problem
    (w[0] = 0)."""
    data = data.at[..., 0].set(0)
    n = data.shape[-1] // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    kgrid = grid_backend(cfg, exact=True)(data, angles, nxos, cfg.kernwidth, beta)
    return _adjoint_epilogue(kgrid, n, cfg, beta)


def nufft_forward(
    img: jnp.ndarray,
    angles: jnp.ndarray,
    cfg: ReconConfig,
    nro: int | None = None,
    wrap: bool = True,
) -> jnp.ndarray:
    """Images (..., n, n) -> radial samples (..., npe, nro).

    nro defaults to gridos * n (`src/tron.cu:945`).  ``wrap=False`` clips KB
    footprints at the grid edge (exact transpose of the gridding adjoint);
    ``wrap=True`` reproduces the reference's periodic domain
    (`src/tron.cu:569-570`).  Degridding is the reference's per-sample
    gather (`src/tron.cu:540-577`) in plain XLA.
    """
    n = img.shape[-1]
    nxos = int(n * cfg.gridos)
    if nro is None:
        nro = nxos
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    x = pad_center(img, nxos)
    if cfg.deapodize:
        x = deapodize(x, nxos, cfg.kernwidth, beta)
    kgrid = centered_fft2(x)
    return degrid_radial2d(kgrid, angles, nro, cfg.kernwidth, beta, wrap=wrap)
