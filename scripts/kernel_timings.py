#!/usr/bin/env python
"""Time each hand-written kernel against the plain XLA version of the same
op at the whole-body frame width (6 coils, 204 spokes x 512 readouts,
512^2 oversampled grid -> 256^2 image), on the GPU.

    python scripts/kernel_timings.py [--sweep]

Prints one line per measurement (milliseconds per frame, NRMSE against the
plain reference at precision HIGHEST) and the card's name and power limit.
``--sweep`` also times the gridder's block-size candidates.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed(fn, *args, reps=20):
    """Mean seconds per call over ``reps`` back-to-back calls, after one
    warm-up call; ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def nrmse(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("error: no GPU", file=sys.stderr)
        return 1
    print("devices:", jax.devices())
    print("card:", card())

    from tron_jax.kernels.kb import kb_beta
    from tron_jax.ops import grid_triton
    from tron_jax.ops.degrid import degrid_radial2d
    from tron_jax.ops.fftops import (
        centered_ifft2_unnormalized,
        crop_center,
        deapodize,
    )
    from tron_jax.ops.grid import grid_radial2d
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.trajectory import ramlak_sdc, spoke_angles

    nc, npe, nro = 6, 204, 512
    n, nxos, kw = nro // 2, nro, 2.0
    beta = kb_beta(kw, 2.0)
    angles = spoke_angles(npe, "golden", 0)
    img = shepp_logan(n)[None] * birdcage_sensitivities(n, nc)
    kimg = jnp.fft.fftshift(
        jnp.fft.fft2(jnp.fft.ifftshift(jnp.pad(
            jnp.asarray(img), ((0, 0), (n // 2, n // 2), (n // 2, n // 2))),
            axes=(-2, -1))), axes=(-2, -1))
    data = jax.jit(lambda g: degrid_radial2d(g, angles, nro, kw, beta))(kimg)
    data = data * ramlak_sdc(nro, npe).astype(data.dtype)

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda d: grid_radial2d(d, angles, nxos, kw, beta))(data)
        ref = np.asarray(ref)

    def gridder(prec):
        return jax.jit(lambda d: grid_triton.grid_radial2d_triton(
            d, angles, nxos, kw, beta, precision=prec))

    rows = []
    for prec in ("fast", "accurate"):
        f = gridder(prec)
        rows.append((f"grid triton {prec}", timed(f, data), nrmse(f(data), ref)))

    with jax.default_matmul_precision("highest"):
        dense = jax.jit(lambda d: grid_radial2d(d, angles, nxos, kw, beta))
        rows.append(("grid dense einsum HIGHEST", timed(dense, data, reps=3),
                     nrmse(dense(data), ref)))

    def scatter(d):
        # transpose of the clip-mode gather degrid: a 25-tap scatter-add
        d = d.at[..., 0].set(0)
        zero = jnp.zeros((nc, nxos, nxos), jnp.complex64)
        (g,) = jax.linear_transpose(
            lambda k: degrid_radial2d(k, angles, nro, kw, beta, wrap=False),
            zero)(d)
        return g / (nxos * npe)

    sc = jax.jit(scatter)
    rows.append(("grid scatter-add (degrid transpose)", timed(sc, data),
                 nrmse(sc(data), ref)))

    # epilogue: centered unnormalized IFFT + crop + deapod, 6 x 512^2 -> 256^2
    kg = jnp.asarray(ref)

    def fft_epi(k):
        return deapodize(crop_center(centered_ifft2_unnormalized(k), n),
                         nxos, kw, beta)

    fe = jax.jit(fft_epi)
    rows.append(("epilogue jnp.fft", timed(fe, kg), 0.0))

    # degrid: 25-tap gather, 6 x 512^2 grid -> 204 x 512 samples per coil
    for wrap in (True, False):
        dg = jax.jit(lambda k, wrap=wrap: degrid_radial2d(
            k, angles, nro, kw, beta, wrap=wrap))
        t = timed(dg, kg)
        # least bytes: read the grid once, write the samples once
        nbytes = nc * nxos * nxos * 8 + nc * npe * nro * 8
        rows.append((f"degrid gather wrap={wrap}", t, 0.0))
        print(f"degrid wrap={wrap}: {nbytes / t / 1e12:.3f} TB/s, "
              f"{nbytes / 3.35e12 / t:.4f} of the 3.35 TB/s HBM peak")

    # end to end through recon_frames: sliding-window whole-body frames
    import dataclasses

    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_frames

    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      adjoint=True)
    rng = np.random.default_rng(0)
    for label, c, nz in (
        ("recon_frames triton fast", cfg, 956),
        ("recon_frames triton accurate",
         dataclasses.replace(cfg, precision="accurate"), 956),
        ("recon_frames plain einsum HIGHEST",
         dataclasses.replace(cfg, backend="jnp"), 16),
    ):
        npe1 = npe + (nz - 1) * 21
        d = jnp.asarray((rng.standard_normal((nc, npe1, nro)) +
                         1j * rng.standard_normal((nc, npe1, nro))
                         ).astype(np.complex64))
        t = timed(lambda x, c=c, nz=nz: recon_frames(x, c, npe, 21, nz), d,
                  reps=3)
        rows.append((f"{label} ({nz} frames), per frame", t / nz, 0.0))

    for name, t, err in rows:
        print(f"{name:40s} {t * 1e3:10.4f} ms  nrmse {err:.3e}")

    if args.sweep:
        base = (grid_triton.TILE, grid_triton.CHANNEL_BLOCK,
                grid_triton.NUM_WARPS, grid_triton.NUM_STAGES)
        for tile, cb, nw, ns in [
            (16, 4, 4, 2), (16, 12, 4, 2), (32, 4, 4, 2), (32, 6, 4, 2),
            (32, 12, 4, 2), (32, 12, 8, 2), (32, 6, 4, 3), (32, 6, 8, 1),
            (64, 4, 8, 2), (64, 2, 4, 2),
        ]:
            (grid_triton.TILE, grid_triton.CHANNEL_BLOCK,
             grid_triton.NUM_WARPS, grid_triton.NUM_STAGES) = tile, cb, nw, ns
            try:
                f = gridder("fast")
                print(f"sweep tile={tile} cb={cb} warps={nw} stages={ns}: "
                      f"{timed(f, data) * 1e3:.4f} ms nrmse "
                      f"{nrmse(f(data), ref):.3e}", flush=True)
            except Exception as e:  # a candidate the compiler refuses
                print(f"sweep tile={tile} cb={cb} warps={nw} stages={ns}: "
                      f"failed {type(e).__name__}: {str(e)[:200]}", flush=True)
        (grid_triton.TILE, grid_triton.CHANNEL_BLOCK,
         grid_triton.NUM_WARPS, grid_triton.NUM_STAGES) = base
    print("card:", card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
