"""Forward/adjoint roundtrip on the analytic Shepp-Logan phantom.

The library analog of the reference's RUNME1 -> RUNME3 phantom flow
(`src/RUNME1_tron_degrid_phantom.sh`,
`src/RUNME3_tron_grid_all.sh:6`): synthesize golden-angle radial k-space
from an image with the forward NUFFT (degridding), reconstruct it with
the adjoint (gridding + IFFT + deapodization), and report accuracy.

Runs on whatever JAX platform is default (the GPU when available); pass
--cpu to force CPU.  Usage:

    python examples/01_phantom_roundtrip.py [--n 128] [--npe 256] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=128, help="image size")
    p.add_argument("--npe", type=int, default=256, help="number of spokes")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from tron_jax import ReconConfig, nufft_adjoint, nufft_forward
    from tron_jax.phantom import shepp_logan
    from tron_jax.trajectory import spoke_angles

    cfg = ReconConfig(golden_angle=True, sdc="ideal")
    img = shepp_logan(args.n).astype(np.complex64)
    angles = jnp.asarray(spoke_angles(args.npe, "golden", 0))

    # image -> radial k-space (nc=1 leading axis; any leading axes batch)
    data = nufft_forward(jnp.asarray(img[None]), angles, cfg)
    # radial k-space -> image (SDC + gridding + centered IFFT + deapod)
    rec = np.asarray(nufft_adjoint(data, angles, cfg))[0]

    m, ref = np.abs(rec), np.abs(img)
    s = float(np.vdot(m, ref).real / np.vdot(m, m).real)  # ls scale
    err = np.linalg.norm(s * m - ref) / np.linalg.norm(ref)
    print(f"n={args.n} npe={args.npe}  roundtrip magnitude NRMSE: {err:.3e}")
    # plain-adjoint accuracy: Gibbs ringing off the phantom's edges plus
    # radial undersampling streaks dominate; 0.3 is a sanity gate, the
    # quantitative anchors live in tests/ and scripts/dataset_metrics.py
    return 0 if err < 0.3 else 1


if __name__ == "__main__":
    raise SystemExit(main())
