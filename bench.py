#!/usr/bin/env python
"""Headline benchmark on one GPU: golden-angle whole-body gridding recon
throughput, plus the other pipelines at their reference geometries.

The reference (BASELINE.md) reconstructs the whole-body CMT dataset (nc=6,
nro=512, npe1=20271, -u 0.4 -d 21 -a -G => 956 frames of 256^2) in 3.28 s
on the paper's GPU = ~183 Msamples/s of gridding throughput (counting
nz*nc*nro*npe1work coil-samples).  This script times the same per-frame
work (identical frame geometry and recon pipeline) and reports
coil-samples/s.  It needs a GPU and prints exactly one JSON line, with the
device and the card's name and power limit; a failed section fails the run.

    python bench.py              # BENCH_FRAMES=956 frames by default
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

NFRAMES = int(os.environ.get("BENCH_FRAMES", "956"))
BASELINE_MSPS = 183.0  # derived reference throughput (BASELINE.md)


def timed(fn, *args, reps=3):
    """Mean wall seconds of fn(*args) over reps calls after two warm-up
    calls (the first compiles); each call ends in block_until_ready."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def main():
    import jax
    import jax.numpy as jnp

    from tron_jax.config import ReconConfig
    from tron_jax.nufft import nufft_adjoint, nufft_forward
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.recon import recon_frames, recon_frames_incremental
    from tron_jax.trajectory import spoke_angles
    from tron_jax.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU (platform {dev.platform!r})")
    enable_compilation_cache()
    name, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].split(", ")
    result = {
        "metric": "gridding_throughput_whole_body",
        "unit": "Msamples/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": {"name": name, "power_limit": power},
    }

    # whole-body frame geometry: nro=512, npe1work=204, slide=21 (RUNME3:10)
    nc, nro, slide = 6, 512, 21
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=slide,
                      adjoint=True)
    work = cfg.npe1work(nro, 10**9)  # 204
    rng = np.random.default_rng(0)

    def acquisition(nz):
        npe1 = work + (nz - 1) * slide
        return jnp.asarray((rng.standard_normal((nc, npe1, nro)) +
                            1j * rng.standard_normal((nc, npe1, nro))
                            ).astype(np.complex64))

    def msps(nz, dt):
        return nz * nc * nro * work / dt / 1e6

    # --- headline: direct and incremental sliding-window recon --------------
    d = acquisition(NFRAMES)
    dt = timed(lambda x: recon_frames(x, cfg, work, slide, NFRAMES), d)
    result.update(value=msps(NFRAMES, dt), frames=NFRAMES, seconds_per_run=dt,
                  vs_baseline=msps(NFRAMES, dt) / BASELINE_MSPS)
    dt_i = timed(lambda x: recon_frames_incremental(x, cfg, work, slide, NFRAMES), d)
    result["incremental_msamples_per_s"] = msps(NFRAMES, dt_i)
    a = recon_frames(d, cfg, work, slide, NFRAMES)
    b = recon_frames_incremental(d, cfg, work, slide, NFRAMES)
    num = jnp.linalg.norm((b - a).reshape(NFRAMES, -1), axis=1)
    den = jnp.linalg.norm(a.reshape(NFRAMES, -1), axis=1)
    result["nrmse_incremental_vs_direct"] = float(jnp.max(num / den))

    cfg_a = dataclasses.replace(cfg, precision="accurate")
    dt_a = timed(lambda x: recon_frames(x, cfg_a, work, slide, NFRAMES), d)
    result["accurate_msamples_per_s"] = msps(NFRAMES, dt_a)
    del d, a, b

    # --- accuracy: phantom x birdcage frame vs the plain gridder at fp32 -----
    n = nro // 2
    img = jnp.asarray(shepp_logan(n)[None] * birdcage_sensitivities(n, nc))
    angles = spoke_angles(work, "golden", 0)
    data_s = jax.jit(lambda x: nufft_forward(x, angles, cfg, nro=nro))(img)
    ref = jax.jit(lambda x: nufft_adjoint(
        x, angles, dataclasses.replace(cfg, backend="jnp")))(data_s)
    for key, c in (("nrmse_fast_vs_fp32", cfg), ("nrmse_accurate_vs_fp32", cfg_a)):
        got = jax.jit(lambda x, c=c: nufft_adjoint(x, angles, c))(data_s)
        result[key] = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))

    # --- forward (degrid) throughput, images made on the device -------------
    nz_f = 128
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    imgs = (jax.random.normal(k1, (nz_f, nc, n, n)) +
            1j * jax.random.normal(k2, (nz_f, nc, n, n))).astype(jnp.complex64)

    @jax.jit
    def fwd(stack):
        return jax.lax.map(lambda z: nufft_forward(z, angles, cfg, nro=nro), stack,
                           batch_size=cfg.frame_block)

    result["degrid_msamples_per_s"] = msps(nz_f, timed(fwd, imgs))
    del imgs

    # --- non-default oversampling and kernel width (128 frames each) --------
    d128 = acquisition(128)
    for tag, c in (("osf15", dataclasses.replace(cfg, gridos=1.5)),
                   ("osf25", dataclasses.replace(cfg, gridos=2.5)),
                   ("kw3", dataclasses.replace(cfg, kernwidth=3.0))):
        dt = timed(lambda x, c=c: recon_frames(x, c, work, slide, 128), d128)
        result[f"adjoint_msamples_per_s_{tag}"] = msps(128, dt)
    del d128

    # --- CGNR seconds per iteration, pair vs Toeplitz (one frame) -----------
    from tron_jax.solver import cgnr_radial2d

    data_c = acquisition(1)

    def sec_per_run(niter, toeplitz):
        c = dataclasses.replace(cfg, niter=niter, toeplitz=toeplitz)
        return timed(jax.jit(lambda x: cgnr_radial2d(x, angles, c, rtol=0.0)),
                     data_c)

    for tag, tp, hi in (("pair", False, 34), ("toeplitz", True, 258)):
        lo_t, hi_t = sec_per_run(2, tp), sec_per_run(hi, tp)
        result[f"cgnr_{tag}_s_per_iter"] = (hi_t - lo_t) / (hi - 2)

    # --- CGNR series: swallowing-class dynamic acquisition ------------------
    # nc=4, nro=256, -u 0.5 -d 21: 128 spokes per 128^2 frame, 137 frames,
    # phantom-derived data with exact truth; wall time and best-scale
    # magnitude NRMSE vs the phantom per mode
    nc_s, nro_s, npe1_s, slide_s, nz_s = 4, 256, 3000, 21, 137
    n_s = nro_s // 2
    cfg0 = dataclasses.replace(cfg, data_undersamp=0.5)
    work_s = cfg0.npe1work(nro_s, npe1_s)
    truth = np.abs(shepp_logan(n_s))
    img_s = jnp.asarray(shepp_logan(n_s)[None] * birdcage_sensitivities(n_s, nc_s))
    angles_all = spoke_angles(npe1_s, "golden", 0)
    data_ser = jax.jit(lambda x: nufft_forward(x, angles_all, cfg0, nro=nro_s))(img_s)
    for tag, ni, tp in (("adjoint", 0, False), ("pair", 10, False),
                        ("toeplitz", 10, True)):
        c = dataclasses.replace(cfg0, niter=ni, toeplitz=tp)
        run = lambda x, c=c: recon_frames(x, c, work_s, slide_s, nz_s)
        result[f"cgnr_series_{tag}_wall_s"] = timed(run, data_ser)
        errs = []
        for f in np.abs(np.asarray(run(data_ser))):
            s = float(np.vdot(f, truth).real / max(np.vdot(f, f).real, 1e-30))
            errs.append(np.linalg.norm(s * f - truth) / np.linalg.norm(truth))
        result[f"cgnr_series_{tag}_nrmse_truth"] = float(np.mean(errs))
    result["cgnr_series_frames"] = nz_s

    # --- koosh (-3) stack of stars: 32 slices of 256-readout frames ---------
    from tron_jax.recon import recon_radial2d

    nro_k, npe2 = 256, 32
    cfg_k = dataclasses.replace(cfg, koosh=True, prof_slide=0, data_undersamp=1.0)
    work_k = cfg_k.npe1work(nro_k, 10**9)
    dk = (rng.standard_normal((nc, 1, nro_k, work_k, npe2)) +
          1j * rng.standard_normal((nc, 1, nro_k, work_k, npe2))).astype(np.complex64)
    result["koosh_slices_per_s_e2e"] = npe2 / timed(
        lambda x: recon_radial2d(x, cfg_k), dk)

    # --- Walsh adaptive coil combine ----------------------------------------
    from tron_jax.ops.coil import coil_combine_walsh_frames

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    imgs_w = (jax.random.normal(k1, (64, nc, n, n)) +
              1j * jax.random.normal(k2, (64, nc, n, n))).astype(jnp.complex64)
    walsh = jax.jit(lambda x: coil_combine_walsh_frames(x, 1))
    result["walsh_ms_per_frame"] = timed(walsh, imgs_w) / 64 * 1e3

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
