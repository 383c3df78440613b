"""Radial trajectory geometry: spoke angles, Ram-Lak density compensation,
sliding-window frame indexing.

Pure functions of static shapes — all jit/vmap-safe.  Conventions follow the
reference (`src/tron.cu:372-378, 405-416, 505-530`): a spoke
at angle t has direction (cos t, sin t); readout sample ro of a spoke sits at
signed radius (ro - nro/2) * nxos/nro in oversampled-grid units, so with the
default gridos=2 (nxos == nro) samples lie exactly on integer radii.
"""

from __future__ import annotations

import jax.numpy as jnp

from tron_jax.config import PHI, AngleScheme

TWO_PI = 2.0 * jnp.pi


def modang(x: jnp.ndarray) -> jnp.ndarray:
    """Wrap angles to [0, 2*pi) (`src/tron.cu:372-378`)."""
    y = jnp.mod(x, TWO_PI)
    return jnp.where(y < 0, y + TWO_PI, y)


def minangulardist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Minimum angular distance treating a and a+pi as equivalent
    (`src/tron.cu:380-388`; defined but unused there — useful for spoke
    dedup / view-sharing logic)."""
    d1 = jnp.abs(modang(a - b))
    d2 = jnp.abs(modang(a + jnp.pi) - b)
    d3 = TWO_PI - d1
    d4 = TWO_PI - d2
    return jnp.minimum(jnp.minimum(d1, d2), jnp.minimum(d3, d4))


def spoke_angles(
    npe: int,
    scheme: str,
    skip: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """Angles of the npe spokes of one frame.

    ``skip`` is the global profile offset (skip_angles + frame offset); only
    the golden-angle scheme depends on it (`src/tron.cu:509`, where linear
    angles are local to the frame).  It may be a traced value, so frames can
    be vmapped.
    """
    pe = jnp.arange(npe, dtype=jnp.float32)
    if scheme == AngleScheme.GOLDEN:
        return modang(PHI * (pe + jnp.asarray(skip, jnp.float32)))
    if scheme == AngleScheme.LINEAR_FULL:
        return pe * (TWO_PI / npe) + jnp.pi * 0.5
    if scheme == AngleScheme.LINEAR_HALF:
        return pe * (jnp.pi / npe)
    raise ValueError(f"unknown angle scheme {scheme!r}")


def ramlak_sdc(nro: int, npe: int, dtype=jnp.float32) -> jnp.ndarray:
    """Implicit Ram-Lak sample density compensation along the readout.

    sdc[ro] = a*|ro - nro/2| + b with a = (2 - 2/npe)/nro, b = 1/npe
    (`src/tron.cu:405-416`): linear ramp from 1/npe at the k-space center to
    ~1 at the edge, making a separate SDC/presort step unnecessary.
    """
    a = (2.0 - 2.0 / npe) / nro
    b = 1.0 / npe
    r = jnp.arange(nro, dtype=dtype)
    return a * jnp.abs(r - nro // 2) + b


def ideal_sdc(nro: int, npe: int, dtype=jnp.float32) -> jnp.ndarray:
    """Exact polar cell-area density weights (an improvement over the
    reference's Ram-Lak ramp, whose +1/npe intercept over-weights the lowest
    frequencies — see ReconConfig.sdc).

    Sample at signed radius r covers an annulus sector of area pi*|r|/npe
    (|r| >= 1); the shared DC cell is a disc of radius 1/2 split across the
    npe spokes: pi/(4*npe).  With these weights A^H W A ~ Identity (unit
    gain) for fully-sampled radial data.
    """
    r = jnp.abs(jnp.arange(nro, dtype=dtype) - nro // 2)
    return jnp.where(r == 0, jnp.pi / (4 * npe), jnp.pi * r / npe).astype(dtype)


def sample_radii(nro: int, nxos: int, dtype=jnp.float32) -> jnp.ndarray:
    """Signed sample radius of each readout index, in oversampled grid units.

    ro -> (ro/nro - 1/2) * nxos  (`src/tron.cu:554, 560-561`).
    """
    ro = jnp.arange(nro, dtype=dtype)
    return (ro / nro - 0.5) * nxos


def grid_radius_to_ro(r: jnp.ndarray, nro: int, nxos: int) -> jnp.ndarray:
    """Readout index holding the sample at integer grid radius r.

    ridx = trunc(r*nro/nxos) + nro/2, C-truncation semantics
    (`src/tron.cu:517`); the identity map + nro/2 when nxos == nro.
    """
    ridx = jnp.trunc(r.astype(jnp.float32) * (nro / nxos)).astype(jnp.int32)
    return ridx + nro // 2
