"""Synthesize a golden-angle multicoil radial acquisition .ra file (the
stand-in for the reference's git-lfs datasets: ex_whole_body / optic_nerve /
swallowing — dims (nc, nt, nro, npe1, 1), e.g. 6x1x512x20271 for whole-body,
SURVEY.md §2.5).

Data = forward NUFFT of coil-weighted Shepp-Logan at the requested spoke
count, so adjoint recons of any sliding window see consistent anatomy.
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("outfile")
    p.add_argument("--nc", type=int, default=6)
    p.add_argument("--nro", type=int, default=512)
    p.add_argument("--npe", type=int, default=1479)
    p.add_argument("--chunk", type=int, default=512, help="spokes per forward call")
    args = p.parse_args(argv)

    from tron_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    from tron_jax.config import ReconConfig
    from tron_jax.io import ra_write
    from tron_jax.nufft import nufft_forward
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.trajectory import spoke_angles
    from tron_jax.config import AngleScheme

    import jax.numpy as jnp

    n = args.nro // 2
    img = shepp_logan(n)
    maps = birdcage_sensitivities(n, args.nc)
    coilimg = jnp.asarray(maps * img[None])  # (nc, n, n)

    import functools

    import jax

    cfg = ReconConfig(golden_angle=True)
    chunk = min(args.chunk, args.npe)
    # one jitted forward reused across equal-shaped chunks
    fwd = jax.jit(functools.partial(nufft_forward, cfg=cfg, nro=args.nro))
    chunks = []
    for pe0 in range(0, args.npe, chunk):
        npe = min(chunk, args.npe - pe0)
        angles = spoke_angles(chunk, AngleScheme.GOLDEN, pe0)
        chunks.append(np.asarray(fwd(coilimg, angles))[:, :npe])
    data = np.concatenate(chunks, axis=1)  # (nc, npe, nro)

    # .ra dims (nc, nt, nro, npe1, npe2) — nc fastest
    arr = np.transpose(data, (0, 2, 1))[:, None, :, :, None].astype(np.complex64)
    ra_write(arr, args.outfile)
    print(f"wrote {args.outfile} dims={arr.shape}")


if __name__ == "__main__":
    main()
