#!/usr/bin/env python
"""Cross-implementation comparison harness — the rebuild of the reference's
RUNME2/RUNME4-7 MATLAB scripts: reconstruct the same dataset with multiple
methods, report NMSE/RMSE/SSIM tables, persist CSV + figures.

Methods compared:
  * tron-jnp     — the plain XLA gridder
  * tron-pallas  — the Triton gridding kernel (GPU; run in a child process
                   on the default platform while this process stays on the
                   CPU, so only the child holds the card)
  * oracle       — exact weighted adjoint DTFT (the accuracy gold standard,
                   playing IRT's role)

Platform handling: the main process pins the CPU platform (JAX_PLATFORMS=cpu
before JAX starts; the oracle runs there), and the kernel timing runs in a
child process that keeps the default platform (the GPU).

Usage: python scripts/compare_recon.py [--n 64] [--npe 128] [--out output/]
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time


# runnable without an editable install (as paper_plots.py)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--npe", type=int, default=128)
    p.add_argument("--golden", action="store_true")
    p.add_argument("--out", default="output")
    p.add_argument("--skip-oracle", action="store_true")
    p.add_argument("--skip-pallas", action="store_true")
    p.add_argument(
        "--pallas-worker",
        nargs=2,
        metavar=("DATA_NPY", "OUT_NPY"),
        help="internal: run the kernel adjoint on the default (GPU) platform",
    )
    return p.parse_args(argv)


def pallas_worker(args):
    """Child process: default platform (the GPU), kernel adjoint, timed."""
    import numpy as np

    from tron_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from tron_jax.config import AngleScheme, ReconConfig
    from tron_jax.nufft import nufft_adjoint
    from tron_jax.trajectory import spoke_angles

    data_path, out_path = args.pallas_worker
    data = np.load(data_path)
    scheme = AngleScheme.GOLDEN if args.golden else AngleScheme.LINEAR_HALF
    base = dict(angle_scheme=None if args.golden else scheme, golden_angle=args.golden)
    cfg = ReconConfig(backend="pallas", **base)
    angles = jnp.asarray(spoke_angles(args.npe, scheme, 0))
    f = jax.jit(lambda d: nufft_adjoint(d, angles, cfg))
    d = jnp.asarray(data)
    jax.block_until_ready(f(d))  # compile
    t0 = time.perf_counter()
    r = jax.block_until_ready(f(d))
    dt = time.perf_counter() - t0
    r = np.asarray(r)
    np.save(out_path, r)
    print(json.dumps({"time_s": dt, "platform": jax.devices()[0].platform}))


def main():
    args = parse_args()
    if args.pallas_worker:
        return pallas_worker(args)

    # ---- main process: on the CPU, off the card ---------------------------
    os.environ["JAX_PLATFORMS"] = "cpu"

    from tron_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    import jax

    import jax.numpy as jnp
    import numpy as np

    from tron_jax.config import AngleScheme, ReconConfig
    from tron_jax.metrics import nmse, nrmse, ssim
    from tron_jax.nufft import nufft_adjoint, nufft_forward
    from tron_jax.oracle import oracle_adjoint_recon
    from tron_jax.phantom import shepp_logan
    from tron_jax.trajectory import spoke_angles
    from tron_jax.viz import compare as viz_compare, mosaic

    os.makedirs(args.out, exist_ok=True)
    n, npe = args.n, args.npe
    scheme = AngleScheme.GOLDEN if args.golden else AngleScheme.LINEAR_HALF
    base = dict(angle_scheme=None if args.golden else scheme, golden_angle=args.golden)

    img = shepp_logan(n)
    angles = jnp.asarray(spoke_angles(npe, scheme, 0))
    cfg0 = ReconConfig(**base)
    nro = int(cfg0.gridos * n)
    fwd = jax.jit(lambda x: nufft_forward(x, angles, cfg0, nro=nro))
    data = fwd(jnp.asarray(img))

    recons, times = {}, {}

    cfg = ReconConfig(backend="jnp", **base)
    f = jax.jit(lambda d: nufft_adjoint(d, angles, cfg))
    r = np.asarray(f(data))  # compile
    t0 = time.perf_counter()
    r = np.asarray(f(data))
    times["tron-jnp"] = time.perf_counter() - t0
    recons["tron-jnp"] = r

    if not args.skip_pallas:
        # the kernel needs the GPU; the child keeps the default platform
        with tempfile.TemporaryDirectory() as td:
            dpath = os.path.join(td, "data.npy")
            opath = os.path.join(td, "recon.npy")
            np.save(dpath, np.asarray(np.asarray(data)))
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--pallas-worker", dpath, opath,
                   "--n", str(n), "--npe", str(npe)]
            if args.golden:
                cmd.append("--golden")
            env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
            try:
                proc = subprocess.run(
                    cmd, env=env, capture_output=True, text=True, timeout=600
                )
                if proc.returncode != 0:
                    err_lines = proc.stderr.strip().splitlines()
                    raise RuntimeError(
                        err_lines[-1] if err_lines
                        else f"worker exited {proc.returncode} with no stderr"
                    )
                info = json.loads(proc.stdout.strip().splitlines()[-1])
                times["tron-pallas"] = info["time_s"]
                recons["tron-pallas"] = np.load(opath)
                print(f"# tron-pallas ran on platform: {info['platform']}")
            except Exception as e:
                print(f"# tron-pallas: skipped ({type(e).__name__}: {e})")

    if not args.skip_oracle and n <= 512:
        t0 = time.perf_counter()
        r = np.asarray(
            jax.jit(oracle_adjoint_recon, static_argnums=(2, 3, 4))(
                data, angles, cfg0, n, nro
            )
        )
        times["oracle"] = time.perf_counter() - t0
        recons["oracle"] = r

    ref = recons.get("oracle", recons.get("tron-jnp"))
    rows = []
    for name, r in recons.items():
        rows.append(
            {
                "method": name,
                "time_s": round(times[name], 4),
                "nmse_vs_ref": round(nmse(r, ref), 8),
                "nrmse_vs_ref": round(nrmse(r, ref), 8),
                "ssim_vs_ref": round(ssim(np.abs(r), np.abs(ref)), 6),
                "nrmse_vs_truth": round(nrmse(np.abs(r) / np.abs(r).max(), np.abs(img) / max(np.abs(img).max(), 1e-9)), 6),
            }
        )
        print(rows[-1])

    csv_path = os.path.join(args.out, f"compare_n{n}_npe{npe}.csv")
    with open(csv_path, "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=rows[0].keys())
        wtr.writeheader()
        wtr.writerows(rows)
    print(f"# wrote {csv_path}")

    names = list(recons)
    mosaic(
        np.stack([np.abs(recons[k]) for k in names]),
        os.path.join(args.out, f"recons_n{n}.png"),
        title=" | ".join(names),
    )
    if len(names) >= 2:
        viz_compare(
            recons[names[0]], recons[names[-1]],
            os.path.join(args.out, f"diff_{names[0]}_vs_{names[-1]}.png"),
            labels=(names[0], names[-1]),
        )
    print("# figures written to", args.out)


if __name__ == "__main__":
    main()
