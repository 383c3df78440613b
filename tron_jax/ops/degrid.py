"""Forward radial degridding: sample a centered oversampled k-space grid at
radial trajectory points with Kaiser-Bessel interpolation.

Design: the reference's per-sample gather.  Each sample owns its output
(exclusive ownership — the race-freedom property of the reference,
`src/tron.cu:540-577`) and the (2*kw+1)^2 neighborhood is walked with
*static* offset loops, so the whole op is (2kw+1)^2 flat gathers + fused
multiply-adds; no dynamic control flow, no scatter.  A 6 x 512^2 complex
grid is 12.6 MB and stays in the GPU's L2 across the taps.

Convention notes vs the reference: we use x = r*cos(t), y = r*sin(t) for both
grid and degrid (the reference swaps sin/cos between directions,
`src/tron.cu:514-515` vs `:559-561` — a quirk, documented in SURVEY.md §7,
equivalent to a transpose), and center at n//2 (== the reference's (n+1)/2
under C integer division for even n).
"""

from __future__ import annotations

import jax.numpy as jnp

from tron_jax.kernels.kb import kb_kernel


def degrid_radial2d(
    kgrid: jnp.ndarray,
    angles: jnp.ndarray,
    nro: int,
    kernwidth: float,
    beta: float,
    wrap: bool = True,
) -> jnp.ndarray:
    """kgrid: (..., nyos, nxos) centered complex k-space; angles: (npe,).

    ``wrap=False`` clips KB footprints at the grid boundary instead of the
    reference's periodic wrap (`src/tron.cu:569-570`) — this makes degrid
    the exact transpose of the gridding op (which clips), as the CGNR
    operator pair requires.

    Returns samples (..., npe, nro).  Sample ro of spoke t sits at radius
    (ro/nro - 1/2)*nxos grid units (`src/tron.cu:554, 560-561`); the grid is
    treated as periodic (index mod n, `src/tron.cu:569-570`).
    """
    n = kgrid.shape[-1]
    batch = kgrid.shape[:-2]
    flat = kgrid.reshape(*batch, n * n)

    ro = jnp.arange(nro, dtype=jnp.float32)
    kr = (ro / nro - 0.5) * n                      # (nro,)
    ct = jnp.cos(angles).astype(jnp.float32)       # (npe,)
    st = jnp.sin(angles).astype(jnp.float32)
    xs = kr[None, :] * ct[:, None] + n // 2        # (npe, nro) continuous col
    ys = kr[None, :] * st[:, None] + n // 2        # (npe, nro) continuous row

    x0 = jnp.ceil(xs - kernwidth).astype(jnp.int32)
    y0 = jnp.ceil(ys - kernwidth).astype(jnp.int32)

    noff = int(2 * kernwidth) + 1
    out = jnp.zeros(batch + (angles.shape[0], nro), dtype=kgrid.dtype)
    for dx in range(noff):
        xu = x0 + dx
        wx = kb_kernel(xu.astype(jnp.float32) - xs, kernwidth, beta)
        if not wrap:
            wx = wx * ((xu >= 0) & (xu < n))
        iu = jnp.mod(xu, n)
        for dy in range(noff):
            yu = y0 + dy
            w = wx * kb_kernel(yu.astype(jnp.float32) - ys, kernwidth, beta)
            if not wrap:
                w = w * ((yu >= 0) & (yu < n))
            jv = jnp.mod(yu, n)
            idx = jv * n + iu                       # row-major (y, x)
            vals = jnp.take(flat, idx.reshape(-1), axis=-1)
            vals = vals.reshape(batch + idx.shape)
            out = out + vals * w.astype(kgrid.dtype)
    return out

