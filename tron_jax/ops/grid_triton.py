"""Adjoint radial gridding on Hopper: a Pallas kernel through Triton.

Same sum as tron_jax.ops.grid (the plain reference):

    out[c, Y, X] = scale * sum_pe sum_r  B[pe, r, Y] * s[c, pe, r] * A[pe, r, X]
    A[pe, r, X] = KB(r*cos t_pe - X),  B[pe, r, Y] = KB(r*sin t_pe - Y)

The reference gridder (`src/tron.cu:465-536`) is a race-free gather: each
thread owns one oversampled grid point and loops over the spokes and over
the radii within kernel width, with every channel in registers.  This kernel
keeps that ownership at the grain of a tile:

  * one program per (channel group, output tile) of the oversampled grid,
    which it writes exactly once — no atomics, run-to-run deterministic;
  * the program loops over exactly the spokes whose line crosses its tile
    (grown by the kernel's reach), read from a per-tile hit list that plain
    JAX builds from the frame's angles (_hit_tables);
  * per hit it loads the ``win`` radius rows that the spoke's chord through
    the tile covers, evaluates the separable KB weights in registers
    (_kb_poly), and accumulates, per channel plane, (B * s_c)^T @ A on the
    tensor cores with fp32 accumulation.

Rows of the sample planes sit at radius (u - hr) * row_scale: the integer
grid radii of the reference's trunc-resample (row_scale 1), or the exact
readout radii (row_scale nxos/nro) for the CGNR operator pair.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Block sizes, measured on an H100 at the whole-body geometry (PERF.md).
TILE = 16            # output tile edge (pixels); a power of two, >= 16
CHANNEL_BLOCK = 4    # most channel planes one program accumulates
NUM_WARPS = 4
NUM_STAGES = 2

# --precision fast | accurate -> the tensor-core dot algorithm.  The CPU
# interpreter has no TF32, so interpret mode runs every mode in fp32.
DOT_PRECISION = {
    "fast": jax.lax.DotAlgorithmPreset.TF32_TF32_F32,
    "accurate": jax.lax.DotAlgorithmPreset.F32_F32_F32,
}


@functools.lru_cache(maxsize=32)
def _kb_coeffs(kernwidth: float, beta: float) -> tuple[float, ...]:
    """KB(x) = 0.5/kw * I0(beta*sqrt(q)), q = 1 - (x/kw)^2, as a polynomial
    in q (I0(beta*sqrt(q)) is entire in q): a relative-error-weighted least
    squares fit over q in [0, 1], of the smallest degree in 9..16 whose
    relative error is below 1e-7 (9 suffices at kernwidth 2, 13 at 3)."""
    q = np.linspace(0.0, 1.0, 2001)
    target = np.i0(beta * np.sqrt(q))
    for deg in range(9, 17):
        V = np.vander(q, deg + 1, increasing=True) / target[:, None]
        c, *_ = np.linalg.lstsq(V, np.ones_like(q), rcond=None)
        if np.max(np.abs(V @ c - 1.0)) < 1e-7 or deg == 16:
            return tuple(float(0.5 / kernwidth * ck) for ck in c)
    raise AssertionError("unreachable")


def _kb_poly(x: jnp.ndarray, kernwidth: float, coeffs) -> jnp.ndarray:
    """KB window by Horner's rule on the fitted polynomial in q."""
    r = x * (1.0 / kernwidth)
    q = 1.0 - r * r
    inside = q > 0.0
    qc = jnp.where(inside, q, 0.0)
    acc = jnp.full_like(qc, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * qc + c
    return jnp.where(inside, acc, 0.0)


# how far past the kernel's reach a tile is grown for the hit test: the
# contributing rows then sit strictly inside each chord, whatever the
# rounding of its ends
_MARGIN = 0.5


def window_rows(tile: int, kernwidth: float, row_scale: float) -> int:
    """Radius rows a hit loads: the longest chord of a line through the
    grown tile, in rows, plus the window's floor, as a power of two (>= 16,
    the tensor-core minimum)."""
    diag = math.sqrt(2.0) * (tile - 1 + 2.0 * (kernwidth + _MARGIN))
    need = math.ceil(diag / row_scale) + 2
    return max(16, 1 << (need - 1).bit_length())


def _hit_tables(angles, ntiles, tile, h, kernwidth, n_rows, hr, row_scale, win):
    """Per-tile spoke hit lists.

    A spoke hits a tile when its line r -> (r cos t, r sin t) crosses the
    tile grown by kw + _MARGIN within the radius range of the rows.  Returns
    (hits, w0, count): hits[t, k] is the k-th hitting spoke of tile t,
    w0[t, k] the first row of its window, count[t] the number of hits.
    Entries past count are never read.  Tile (i, j) covers pixels
    [i*tile, (i+1)*tile) x [j*tile, (j+1)*tile), at coordinates minus h."""
    e = kernwidth + _MARGIN
    ii, jj = np.meshgrid(np.arange(ntiles), np.arange(ntiles), indexing="ij")
    y0 = (ii.ravel() * tile - h - e).astype(np.float32)[:, None]
    y1 = ((ii.ravel() + 1) * tile - 1 - h + e).astype(np.float32)[:, None]
    x0 = (jj.ravel() * tile - h - e).astype(np.float32)[:, None]
    x1 = ((jj.ravel() + 1) * tile - 1 - h + e).astype(np.float32)[:, None]
    c = jnp.cos(angles).astype(jnp.float32)[None, :]
    s = jnp.sin(angles).astype(jnp.float32)[None, :]

    def slab(a, lo_edge, hi_edge):
        # r-interval where a*r lies in [lo_edge, hi_edge]
        safe = jnp.where(a == 0, 1.0, a)
        t0, t1 = lo_edge / safe, hi_edge / safe
        inside = (lo_edge <= 0) & (0 <= hi_edge)
        big = jnp.float32(1e9)
        lo = jnp.where(a == 0, jnp.where(inside, -big, big), jnp.minimum(t0, t1))
        hi = jnp.where(a == 0, jnp.where(inside, big, -big), jnp.maximum(t0, t1))
        return lo, hi

    xlo, xhi = slab(c, x0, x1)
    ylo, yhi = slab(s, y0, y1)
    lo = jnp.maximum(jnp.maximum(xlo, ylo), -hr * row_scale)
    hi = jnp.minimum(jnp.minimum(xhi, yhi), (n_rows - 1 - hr) * row_scale)
    hit = hi >= lo                                           # (T, npe)
    w0 = jnp.floor(lo / row_scale).astype(jnp.int32) + hr
    w0 = jnp.clip(w0, 0, max(n_rows, win) - win)
    hits = jnp.argsort(~hit, axis=-1, stable=True).astype(jnp.int32)
    w0 = jnp.take_along_axis(w0, hits, axis=-1)
    return hits, w0, hit.sum(-1).astype(jnp.int32)


def _grid_kernel(
    hits_ref, w0_ref, cnt_ref, ct_ref, st_ref, s_ref, out_ref,
    *, tile, cb, win, ntiles, h, hr, row_scale, kernwidth, coeffs, scale,
    precision,
):
    g = pl.program_id(0)
    t = pl.program_id(1)
    i = t // ntiles
    j = t % ntiles
    X = (jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1) + (j * tile - h))
    Y = (jax.lax.broadcasted_iota(jnp.int32, (1, tile), 1) + (i * tile - h))
    X = X.astype(jnp.float32)
    Y = Y.astype(jnp.float32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (win, 1), 0)

    def hit(k, accs):
        p = hits_ref[t, k]
        u0 = w0_ref[t, k]
        r = ((rows + (u0 - hr)).astype(jnp.float32)) * row_scale  # (win, 1)
        A = _kb_poly(r * ct_ref[p] - X, kernwidth, coeffs)          # (win, tile)
        B = _kb_poly(r * st_ref[p] - Y, kernwidth, coeffs)
        out = []
        for q in range(cb):
            sv = s_ref[g * cb + q, p, pl.ds(u0, win)]               # (win,)
            u = B * sv[:, None]
            out.append(accs[q] + pl.dot(u, A, trans_a=True, precision=precision))
        return tuple(out)

    zero = jnp.zeros((tile, tile), jnp.float32)
    accs = jax.lax.fori_loop(0, cnt_ref[t], hit, (zero,) * cb)
    for q in range(cb):
        out_ref[g * cb + q, pl.ds(i * tile, tile), pl.ds(j * tile, tile)] = (
            accs[q] * scale
        )


def grid_radial2d_triton(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    nxos: int,
    kernwidth: float,
    beta: float,
    precision: str = "fast",
    exact: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """Adjoint gridding, (..., npe, nro) complex -> (..., nxos, nxos)
    complex64, scaled by 1/(nxos*npe) like the reference (`src/tron.cu:532`).

    Default: readouts are resampled onto the integer grid radii (the
    reference's trunc-resample, `src/tron.cu:517`; see ops.grid._radius_map).
    ``exact=True`` grids every readout at its exact radius
    (ro - nro/2) * nxos/nro — the transpose of the clip-mode degrid at any
    gridos.  ``precision`` is a key of DOT_PRECISION.  ``interpret=True``
    runs the kernel in the Pallas interpreter (the CPU tests)."""
    from tron_jax.ops.grid import _radius_map

    *batch, npe, nro = data.shape
    flat = data.reshape((-1, npe, nro))
    if exact:
        ds, n_rows, row_scale = flat, nro, nxos / nro
    else:
        _, ridx, valid = _radius_map(nxos, nro)
        ds = flat if nro == nxos else jnp.take(flat, ridx, axis=-1)
        ds = ds * valid.astype(flat.dtype)
        n_rows, row_scale = nxos, 1.0
    hr = n_rows // 2

    tile = min(TILE, 1 << (max(nxos, 16) - 1).bit_length())
    win = window_rows(tile, kernwidth, row_scale)
    nxp = -(-nxos // tile) * tile           # grid padded to whole tiles
    ntiles = nxp // tile

    c2 = 2 * ds.shape[0]
    groups = -(-c2 // CHANNEL_BLOCK)
    cb = -(-c2 // groups)
    # (C2', npe, rows') f32 planes: channel planes padded to groups*cb, rows
    # padded so every window fits
    planes = jnp.stack([ds.real, ds.imag], axis=1).reshape(c2, npe, n_rows)
    planes = jnp.pad(
        planes.astype(jnp.float32),
        ((0, groups * cb - c2), (0, 0), (0, max(0, win - n_rows))),
    )
    hits, w0, cnt = _hit_tables(
        angles, ntiles, tile, nxos // 2, kernwidth, n_rows, hr, row_scale, win
    )
    prec = DOT_PRECISION[precision]
    if interpret:
        prec = jax.lax.DotAlgorithmPreset.F32_F32_F32
    kernel = functools.partial(
        _grid_kernel, tile=tile, cb=cb, win=win, ntiles=ntiles, h=nxos // 2,
        hr=hr, row_scale=float(row_scale), kernwidth=float(kernwidth),
        coeffs=_kb_coeffs(float(kernwidth), float(beta)),
        scale=1.0 / (nxos * npe), precision=prec,
    )
    args = (
        hits, w0, cnt, jnp.cos(angles).astype(jnp.float32),
        jnp.sin(angles).astype(jnp.float32), planes,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((groups * cb, nxp, nxp), jnp.float32),
        grid=(groups, ntiles * ntiles),
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        backend="triton",
        name="grid_radial2d",
    )(*args)
    out = out[:c2, :nxos, :nxos].reshape(-1, 2, nxos, nxos)
    return (out[:, 0] + 1j * out[:, 1]).reshape(tuple(batch) + (nxos, nxos))
