#!/usr/bin/env python
"""SSIM/NMSE table for dataset-study recons — the RUNME4-7 MATLAB tables'
role (`src/RUNME4_others_grid_slcmt.m:283-312`, which scores TRON against
IRT *on the same data*).  For each requested frame this recomputes the
reference recon of the same profile window with the independent XLA
dense-einsum backend (cross-implementation check, like TRON-vs-IRT) and,
since every synthetic dataset is a forward NUFFT of coil-weighted
Shepp-Logan, also scores against the phantom ground truth (context: shows
the undersampling level, not implementation error).

Usage: python scripts/dataset_metrics.py IMG.ra --data DATA.ra --nc 6 \
          [-G] [-u 0.4] [-d 21] [--csv out.csv] [--frames 0,400,-1]
"""

import argparse
import csv
import os
import sys

import numpy as np

# runnable without an editable install (as paper_plots.py)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("img")
    p.add_argument("--data", required=True, help="source acquisition .ra")
    p.add_argument("--nc", type=int, required=True, help="coils the fixture used")
    p.add_argument("-G", dest="golden", action="store_true")
    p.add_argument("-u", dest="undersamp", type=float, default=1.0)
    p.add_argument("-d", dest="slide", type=int, default=0)
    p.add_argument("--csv", default="output/dataset_metrics.csv")
    p.add_argument("--frames", default="0,-1", help="comma list; -1 = last")
    p.add_argument("--label", default=None)
    p.add_argument(
        "--oracle",
        action="store_true",
        help="also score each frame against the exact chunked DTFT adjoint "
        "at the full frame geometry (the truly independent anchor, playing "
        "IRT's role in src/RUNME4_others_grid_slcmt.m:283-312)",
    )
    args = p.parse_args()

    from tron_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    import jax

    from tron_jax.config import ReconConfig
    from tron_jax.io import ra_read
    from tron_jax.io.native import ra_read_profiles
    from tron_jax.metrics import nmse, ssim
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.recon import reconstruct_frame

    rec = ra_read(args.img)  # (1, nt, nx, ny, nz)
    nz = rec.shape[-1]
    n = rec.shape[2]

    cfg = ReconConfig(
        golden_angle=args.golden,
        data_undersamp=args.undersamp,
        prof_slide=args.slide,
        adjoint=True,
        backend="jnp",
    )
    from tron_jax.io import ra_query

    hdr = ra_query(args.data)
    nro, npe1 = int(hdr.dims[2]), int(hdr.dims[3])
    work, slide, nz2 = cfg.frame_geometry(nro, npe1)
    assert nz2 == nz, (nz2, nz)

    truth = np.sqrt(
        np.sum(
            np.abs(shepp_logan(n)[None] * birdcage_sensitivities(n, args.nc)) ** 2,
            axis=0,
        )
    ).T

    ref_fn = jax.jit(
        lambda w, skip: reconstruct_frame(w, skip, cfg), static_argnums=()
    )

    oracle_fn = None
    if args.oracle:
        import jax.numpy as jnp

        from tron_jax.oracle import oracle_adjoint_recon
        from tron_jax.trajectory import spoke_angles

        @jax.jit
        def _oracle(win, skip):
            """Exact adjoint recon of one (nc, work, nro) window -> SoS (n,n)
            via the canonical oracle recipe (oracle.oracle_adjoint_recon)."""
            ang = spoke_angles(work, cfg.scheme_for("adjoint"), skip)
            img = oracle_adjoint_recon(win, ang, cfg, n, nro)
            return jnp.sqrt(jnp.sum(jnp.abs(img) ** 2, axis=0))

        oracle_fn = _oracle

    def scale_to(a, b):
        s = float(np.vdot(a, b).real / np.vdot(a, a).real)
        return s * a

    rows = []
    for f in (int(x) for x in args.frames.split(",")):
        z = f % nz
        frame = np.abs(rec[0, 0, :, :, z])
        pe0 = z * slide
        win = ra_read_profiles(args.data, pe0, work)[:, 0].transpose(0, 2, 1)
        win_d = jnp.asarray(np.ascontiguousarray(win))
        ref = np.abs(
            np.asarray(ref_fn(win_d, cfg.skip_angles + pe0))
        ).T  # .ra x/y slots are transposed vs the recon's (y, x)
        row = {
            "label": args.label or os.path.basename(args.img),
            "frame": z,
            "ssim_vs_xla": round(float(ssim(frame, ref)), 6),
            "nmse_vs_xla": round(float(nmse(frame, ref)), 7),
            "ssim_vs_truth": round(float(ssim(scale_to(frame, truth), truth)), 6),
            "nmse_vs_truth": round(float(nmse(scale_to(frame, truth), truth)), 6),
        }
        if oracle_fn is not None:
            orc = np.abs(np.asarray(oracle_fn(win_d, cfg.skip_angles + pe0))).T
            row["oracle_nrmse"] = round(
                float(np.linalg.norm(frame - orc) / np.linalg.norm(orc)), 7
            )
            row["oracle_ssim"] = round(float(ssim(frame, orc)), 6)
        rows.append(row)

    # fixed schema regardless of --oracle (blank cells when not computed)
    # so appended runs never produce ragged rows under an older header
    fields = [
        "label", "frame", "ssim_vs_xla", "nmse_vs_xla",
        "ssim_vs_truth", "nmse_vs_truth", "oracle_nrmse", "oracle_ssim",
    ]
    write_header = True
    if os.path.exists(args.csv):
        with open(args.csv, newline="") as fh:
            head = fh.readline().strip()
        if head == ",".join(fields):
            write_header = False
        else:
            # a pre-schema file: appending 8-cell rows under its header
            # would produce ragged rows — move it aside and start fresh
            backup = args.csv + ".old"
            os.replace(args.csv, backup)
            print(f"note: {args.csv} had an older schema; moved to {backup}")
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    with open(args.csv, "a", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=fields, extrasaction="ignore")
        if write_header:
            w.writeheader()
        for r in rows:
            w.writerow(r)
            print(r)


if __name__ == "__main__":
    main()
