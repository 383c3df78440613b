"""Multicoil recon: plain adjoint vs iterative CGNR, SoS vs Walsh combine.

Library-level tour of the solver surface (the reference ships CGNR broken,
`src/tron.cu:670`; here it works, in three operator
modes): simulate a 4-coil golden-angle acquisition with birdcage
sensitivities, reconstruct with

  1. the plain adjoint NUFFT + root-sum-of-squares combine,
  2. CGNR on the normal equations (pair mode),
  3. CGNR with the Toeplitz-embedded normal operator (--toeplitz spirit:
     two FFT pairs per iteration, no degrid/grid),

and compare against the ground-truth phantom.  Usage:

    python examples/02_cgnr_and_coils.py [--n 96] [--npe 144] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--npe", type=int, default=144)
    p.add_argument("--niter", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax.numpy as jnp

    from tron_jax import ReconConfig, cgnr_radial2d, nufft_adjoint, nufft_forward
    from tron_jax.ops.coil import coil_combine_sos
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.trajectory import spoke_angles

    nc = 4
    img = shepp_logan(args.n).astype(np.complex64)
    maps = birdcage_sensitivities(args.n, nc)              # (nc, n, n)
    coils = maps * img[None]
    angles = jnp.asarray(spoke_angles(args.npe, "golden", 0))

    cfg = ReconConfig(golden_angle=True, sdc="ideal", niter=args.niter)
    data = nufft_forward(jnp.asarray(coils.astype(np.complex64)), angles, cfg)

    ref = np.abs(img) * np.linalg.norm(maps, axis=0)  # SoS-weighted truth

    def nrmse(x):
        m = np.abs(np.asarray(x))
        s = float(np.vdot(m, ref).real / np.vdot(m, m).real)  # ls scale
        return float(np.linalg.norm(s * m - ref) / np.linalg.norm(ref))

    adj = coil_combine_sos(nufft_adjoint(data, angles, cfg))
    print(f"adjoint + SoS        NRMSE {nrmse(adj):.3e}")

    cg = coil_combine_sos(cgnr_radial2d(data, angles, cfg))
    print(f"CGNR (pair, {args.niter} it)   NRMSE {nrmse(cg):.3e}")

    cfg_t = dataclasses.replace(cfg, toeplitz=True)
    cgt = coil_combine_sos(cgnr_radial2d(data, angles, cfg_t))
    print(f"CGNR (Toeplitz)      NRMSE {nrmse(cgt):.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
