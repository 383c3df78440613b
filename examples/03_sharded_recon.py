"""Multi-device sliding-window recon on a ('frame', 'coil') device mesh.

The scaling story (SURVEY.md SS5.8): frames are embarrassingly
parallel (the reference's compile-time MULTI_GPU,
`src/tron.h:49`, with zero inter-device traffic), so they
shard over the 'frame' mesh axis; coils shard over 'coil' and the SoS
combine finishes with one psum (over NVLink between the cards of one
host).  This example runs on an 8-device VIRTUAL CPU mesh so it works on
any machine — on a multi-GPU host, drop the host_platform_device_count
override and the same code scales across the cards.

    python examples/03_sharded_recon.py [--n 64] [--frames 16]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--frames", type=int, default=16)
    args = p.parse_args(argv)

    # 8 virtual devices; real multi-chip needs neither line
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from tron_jax import ReconConfig
    from tron_jax.parallel import make_mesh, recon_frames_sharded
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.recon import recon_frames
    from tron_jax.trajectory import spoke_angles

    nc, n = 2, args.n
    nro = 2 * n
    work, slide = 32, 8
    npe1 = work + (args.frames - 1) * slide

    # synthesize a sliding-window multicoil acquisition
    from tron_jax.nufft import nufft_forward

    cfg = ReconConfig(golden_angle=True, adjoint=True)
    img = shepp_logan(n) * birdcage_sensitivities(n, nc)
    angles = jnp.asarray(spoke_angles(npe1, "golden", 0))
    data = nufft_forward(jnp.asarray(img.astype(np.complex64)), angles, cfg)

    mesh = make_mesh(n_frame=4, n_coil=2)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"on {mesh.devices.size} devices")

    out = recon_frames_sharded(data, cfg, mesh, work, slide, args.frames)
    ref = recon_frames(data, cfg, work, slide, args.frames)
    err = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    print(f"{args.frames} frames sharded over DP(frame)=4 x TP(coil)=2; "
          f"NRMSE vs single-device: {err:.2e}")
    return 0 if err < 1e-5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
