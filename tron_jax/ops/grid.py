"""Adjoint radial gridding — the hot op.

The reference computes, for every oversampled grid point (X, Y) and every
spoke t, contributions from the spoke's samples at integer radii r within
kernel width of the point (`src/tron.cu:465-536`):

    grid[Y, X] = 1/(nxos*npe) * sum_pe sum_r KB(r*cos t - X) KB(r*sin t - Y)
                                             * data[pe, ridx(r)]

The reference runs this as a per-thread gather with data-dependent loop
bounds; ops.grid_triton does the same on the GPU.  This file is the plain
XLA form, which the CPU runs and every test compares against.  It uses
that, for fixed spoke pe, the weight *factorizes* over the output axes:

    contrib_pe[Y, X] = sum_r A[r, X] * B[r, Y] * s[r]
    with A[r, X] = KB(r*cos t - X),  B[r, Y] = KB(r*sin t - Y)

so per spoke the update is U = B * s followed by the product U^T @ A.  A
and B are mostly zeros (band structure), so this does about 10^4 times the
work the kernel's 25 taps need at the whole-body width, but it has no
gather, no scatter and no dynamic shapes, and it is deterministic.  The KB
band emerges from the kernel's compact support, so this computes *exactly*
the reference sum (up to the reference's double-count of r == 0 for points
with R < kw, a documented quirk we fix).  The products run at precision
HIGHEST, so a GPU does not round them to TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tron_jax.kernels.kb import kb_kernel


def _radius_map(nxos: int, nro: int):
    """Integer grid radii handled by the gridder and their readout indices.

    rr spans [-nxos/2+1, nxos/2-1] (the reference clamps the band to
    nxos/2-1, `src/tron.cu:501`); ridx = trunc(rr*nro/nxos) + nro/2 with
    C truncation-toward-zero semantics (`src/tron.cu:517`).
    """
    rr = jnp.arange(nxos, dtype=jnp.int32) - nxos // 2
    ridx = jnp.trunc(rr.astype(jnp.float32) * (nro / nxos)).astype(jnp.int32) + nro // 2
    valid = (rr > -(nxos // 2)) & (ridx >= 0) & (ridx < nro)
    return rr.astype(jnp.float32), jnp.clip(ridx, 0, nro - 1), valid


def grid_radial2d(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    nxos: int,
    kernwidth: float,
    beta: float,
    pe_chunk: int = 4,
    raw_rows: bool = False,
) -> jnp.ndarray:
    """data: (..., npe, nro) radial samples (already density-compensated);
    angles: (npe,). Returns (..., nyos, nxos) centered k-space grid, scaled
    by 1/(nxos*npe) like the reference (`src/tron.cu:532`).

    ``raw_rows=True`` grids each readout at its EXACT radius
    ((ro - nro/2) * nxos/nro in grid units) instead of the reference's
    trunc-resample onto integer grid radii (`src/tron.cu:517`) — the exact
    transpose of the clip-mode degrid at any gridos (used by the CGNR
    operator pair; identical to the default path when nro == nxos)."""
    *batch, npe, nro = data.shape
    batch = tuple(batch)

    if raw_rows:
        rr = (jnp.arange(nro, dtype=jnp.float32) - nro // 2) * (nxos / nro)
        ds = data
    else:
        rr, ridx, valid = _radius_map(nxos, nro)
        # resample readouts onto grid radii (identity when nxos == nro)
        ds = jnp.take(data, ridx, axis=-1) * valid.astype(data.dtype)  # (..., npe, nR)

    # pad spokes to a multiple of the chunk (zero data -> zero contribution)
    nch = -(-npe // pe_chunk)
    pad = nch * pe_chunk - npe
    if pad:
        ds = jnp.pad(ds, [(0, 0)] * len(batch) + [(0, pad), (0, 0)])
        angles = jnp.pad(angles, (0, pad))

    X = (jnp.arange(nxos) - nxos // 2).astype(jnp.float32)
    ct = jnp.cos(angles).astype(jnp.float32)
    st = jnp.sin(angles).astype(jnp.float32)

    # reorganize for scan over spoke chunks: (nch, P, ...)
    nR = nro if raw_rows else nxos
    ds_c = jnp.moveaxis(ds, -2, 0).reshape((nch, pe_chunk) + batch + (nR,))
    ct_c = ct.reshape(nch, pe_chunk)
    st_c = st.reshape(nch, pe_chunk)

    def step(acc, inp):
        c, s, sc = inp                              # (P,), (P,), (P, ..., nR)
        kx = rr[None, :, None] * c[:, None, None]   # (P, nR, 1)
        ky = rr[None, :, None] * s[:, None, None]
        A = kb_kernel(kx - X[None, None, :], kernwidth, beta)  # (P, nR, nx)
        B = kb_kernel(ky - X[None, None, :], kernwidth, beta)  # (P, nR, ny)
        sc = jnp.moveaxis(sc, (0, 1 + len(batch)), (-2, -1))   # (..., P, nR)
        U = sc[..., None] * B.astype(sc.dtype)                 # (..., P, nR, ny)
        acc = acc + jnp.einsum(
            "...pry,prx->...yx", U, A.astype(sc.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        return acc, None

    # derive the zero init from the input so its sharding varyance matches
    # the scan output under shard_map (scan carry types must agree)
    acc0 = jnp.zeros(batch + (nxos, nxos), dtype=data.dtype) + 0.0 * ds.reshape(-1)[0]
    acc, _ = jax.lax.scan(step, acc0, (ct_c, st_c, ds_c))
    return acc * (1.0 / (nxos * npe))
