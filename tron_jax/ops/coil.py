"""Coil combination: root-sum-of-squares and Walsh adaptive combine.

References: `src/tron.cu:255-268` (SoS), `:222-253` (power iteration),
`:270-302` (Walsh).  The Walsh combine here is fully vectorized: the
per-pixel channel covariance over a (2*npatch+1)^2 neighborhood is a box
filter of the C^2 outer-product maps (zero padding == the reference's
clamped patch, since out-of-bounds pixels simply contribute nothing), and
the dominant eigenvector comes from the same 5-step power iteration, vmapped
over all pixels at once.  No MAXCHAN=6 cap (src/tron.h:50-51) — any channel
count works.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def coil_combine_sos(coilimg: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Root-sum-of-squares over the channel axis; passthrough if singleton.

    Returns the same dtype as the input with zero imaginary part, matching
    the reference output convention (`src/tron.cu:263-264`).
    """
    if coilimg.shape[axis] == 1:
        return jnp.take(coilimg, 0, axis=axis)
    mag = jnp.sqrt(jnp.sum(jnp.abs(coilimg) ** 2, axis=axis))
    return mag.astype(coilimg.dtype)


def _box_filter(x: jnp.ndarray, npatch: int) -> jnp.ndarray:
    """Sum over a (2*npatch+1)^2 neighborhood with zero padding, separably,
    on the trailing two axes.

    Implemented as 2*(k-1) shifted-slice adds rather than running-sum
    cumsums: XLA fuses the slice+add chain into one elementwise pass,
    whereas a cumsum along an axis can lower to a sequential scan.
    """
    if npatch == 0:
        return x
    k = 2 * npatch + 1
    H, W = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(npatch, npatch), (npatch, npatch)]
    xp = jnp.pad(x, pad)
    rows = xp[..., 0:H, :]
    for i in range(1, k):
        rows = rows + xp[..., i : i + H, :]
    out = rows[..., :, 0:W]
    for j in range(1, k):
        out = out + rows[..., :, j : j + W]
    return out


def coil_combine_walsh(
    coilimg: jnp.ndarray,
    npatch: int = 1,
    niters: int = 5,
) -> jnp.ndarray:
    """Walsh adaptive combine. coilimg: (C, ny, nx) complex.

    Returns (ny, nx) complex: sum_c conj(v_c) * img_c with v the dominant
    eigenvector of the local channel covariance.

    Layout: everything stays channel-leading.  The covariance is kept as
    C*(C+1)/2 Hermitian-unique (ny, nx) planes (A[c2,c1] = conj(A[c1,c2])),
    so the box filter and the power-iteration matvec are plain fused plane
    ops — no (ny, nx, C, C) transposes, ~half the covariance traffic, and
    peak memory ~(C^2/2)*ny*nx*8 B per frame instead of the 2*C^2 the old
    pixel-trailing layout materialized.
    """
    C = coilimg.shape[0]
    if C == 1:
        return coilimg[0]
    # Hermitian-unique covariance planes: A[c1, c2] for c1 <= c2 only.
    pairs = [(c1, c2) for c1 in range(C) for c2 in range(c1, C)]
    outer = jnp.stack(
        [coilimg[c1] * jnp.conj(coilimg[c2]) for c1, c2 in pairs]
    )                                                      # (P, ny, nx)
    A = _box_filter(outer, npatch)                         # (P, ny, nx)
    idx = {p: i for i, p in enumerate(pairs)}

    def matvec(x):
        # y[c1] = sum_c2 A[c1, c2] * x[c2], using A[c2,c1] = conj(A[c1,c2])
        rows = []
        for c1 in range(C):
            acc = 0.0
            for c2 in range(C):
                a = (
                    A[idx[(c1, c2)]]
                    if c1 <= c2
                    else jnp.conj(A[idx[(c2, c1)]])
                )
                acc = acc + a * x[c2]
            rows.append(acc)
        return jnp.stack(rows)

    # power iteration, batched over pixels (`src/tron.cu:222-253`).
    # The all-ones start vector is derived from the input so it inherits
    # its varying-manual-axes type under shard_map (a literal jnp.ones
    # would be 'unvarying' and fail the scan carry type check).
    x = jnp.ones_like(coilimg) + 0 * coilimg               # (C, ny, nx)

    def it(x, _):
        y = matvec(x)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(y) ** 2, axis=0, keepdims=True))
        return y / jnp.where(nrm > 0, nrm, 1.0).astype(y.dtype), None

    v, _ = jax.lax.scan(it, x, None, length=niters)
    return jnp.sum(jnp.conj(v) * coilimg, axis=0)


def coil_combine_walsh_frames(
    stack: jnp.ndarray,
    npatch: int = 1,
    niters: int = 5,
    frame_block: int = 16,
) -> jnp.ndarray:
    """Walsh combine over a frame stack (nz, C, ny, nx) -> (nz, ny, nx).

    Chunks frames through ``lax.map(batch_size=frame_block)`` so the peak
    covariance memory is bounded at frame_block * C*(C+1)/2 * ny * nx * 8 B
    regardless of nz (a plain vmap over hundreds of frames used to OOM the
    16 GB HBM at the whole-body class).
    """
    if stack.shape[1] == 1:
        return stack[:, 0]
    return jax.lax.map(
        lambda ci: coil_combine_walsh(ci, npatch, niters),
        stack,
        batch_size=min(frame_block, stack.shape[0]),
    )


def coil_compress(data: jnp.ndarray, ncomp: int) -> jnp.ndarray:
    """SVD coil compression: (C, npe, nro) k-space -> (ncomp, npe, nro).

    The reference leaves this as a TODO ("look at nc to decide whether to
    coil combine and by how much (can compress)", src/tron.cu:765); here it
    is the standard Buehrer/Huang SCC: stack samples as an (M, C) matrix,
    keep the top right-singular vectors, rotate the data into that basis.
    Compressing 32-channel arrays to ~8 virtual coils before gridding cuts
    the hot-loop channel cost proportionally.
    """
    C = data.shape[0]
    if ncomp >= C:
        return data
    X = data.reshape(C, -1)                       # (C, M)
    # Gram matrix in coil space (C x C) — cheap, one matrix product
    G = X @ X.conj().T
    _, vecs = jnp.linalg.eigh(G)                  # ascending eigenvalues
    basis = vecs[:, ::-1][:, :ncomp]              # top-ncomp components
    Y = basis.conj().T @ X
    return Y.reshape((ncomp,) + data.shape[1:])
