#!/usr/bin/env python
"""Paper-figure pipeline — the rebuild of the reference's figure layer
(`src/paper_plots.m`, `src/whole_body_mosaic.m`, and the timing bar chart /
SSIM table of `src/RUNME4_others_grid_slcmt.m:200-312`).

Produces, under output/figs/:
  timings.csv + timing_bars.png   per-dataset recon seconds, this program
                                  (measured on the GPU, bench.py
                                  methodology) vs the reference's published
                                  paper-GPU numbers
                                  (BASELINE.md; RUNME4:219, RUNME5:145,
                                  RUNME6:147, RUNME7:146)
  ssim_table.png                  rendered view of output/dataset_metrics.csv
                                  (the analog of RUNME4's SSIM table)
  whole_body_mosaic.png           tiled frames of the full-scale recon
                                  (src/whole_body_mosaic.m)

`--measure` runs the timing section on the GPU (and fails without one);
without it the script renders from an existing timings.csv.  Timing
methodology matches bench.py: everything under one jit, warm reps, each
ending in block_until_ready, persistent compilation cache.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIGDIR = "output/figs"

# (label, reference seconds, source) — the paper-GPU numbers being compared
# against.  Geometry fields mirror the RUNME3 stand-in fixtures; whole_body
# is the exact reference geometry (apples-to-apples), the other three are
# same-class stand-ins (the reference's git-lfs datasets are unavailable, so
# their true dims are unrecoverable — noted in the figure caption).
DATASETS = [
    # label, ref_s, nc, nro, undersamp, slide(0 = non-overlapping), npe1, golden
    ("whole_body", 3.28, 6, 512, 0.4, 21, 20271, True),
    ("swallowing", 0.92, 4, 256, 0.5, 21, 3000, True),
    ("linear_phantom", 0.76, 1, 512, 1.0, 512, 512, False),
    ("optic_nerve", 0.32, 4, 256, 0.5, 0, 2176, True),
]

# categorical identity, fixed order (never cycled): this program = blue,
# reference paper-GPU = neutral gray; CVD-safe pair, direct-labeled so
# identity never rides on color alone
C_THIS = "#4477AA"
C_REF = "#9a9a9a"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def measure_timings(csv_path: str) -> None:
    import jax
    import jax.numpy as jnp

    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_frames
    from tron_jax.utils import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("--measure needs a GPU")
    enable_compilation_cache()

    rng = np.random.default_rng(0)
    rows = []
    for label, ref_s, nc, nro, u, slide, npe1, golden in DATASETS:
        cfg = ReconConfig(
            golden_angle=golden,
            angle_scheme=None if golden else "linear_half",
            data_undersamp=u,
            prof_slide=slide,
            adjoint=True,
        )
        work = cfg.npe1work(nro, npe1)
        eff_slide = slide if slide > 0 else work
        nz = max(1, 1 + (npe1 - work) // eff_slide)
        data = (
            rng.standard_normal((nc, npe1, nro))
            + 1j * rng.standard_normal((nc, npe1, nro))
        ).astype(np.complex64)
        d = jnp.asarray(data)

        def run():
            return jax.block_until_ready(
                recon_frames(d, cfg, work, eff_slide, nz)
            )

        run()  # compile
        run()  # warm
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        dt = (time.perf_counter() - t0) / reps
        msps = nz * nc * nro * work / dt / 1e6
        rows.append(
            {
                "dataset": label,
                "frames": nz,
                "seconds": round(dt, 4),
                "ref_gpu_s": ref_s,
                "speedup": round(ref_s / dt, 2),
                "msamples_per_s": round(msps, 1),
                "device": jax.devices()[0].device_kind,
            }
        )
        print(f"{label}: {nz} frames in {dt:.3f} s  ({msps:.0f} Msamp/s)")

    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {csv_path}")


def timing_bars(csv_path: str, out_png: str) -> str | None:
    if not os.path.exists(csv_path):
        print(f"skip timing bars: {csv_path} missing", file=sys.stderr)
        return None
    with open(csv_path) as fh:
        rows = list(csv.DictReader(fh))
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7.2, 0.85 * len(rows) + 1.6))
    y = np.arange(len(rows))
    ours = [float(r["seconds"]) for r in rows]
    ref = [float(r["ref_gpu_s"]) for r in rows]
    h = 0.38
    ax.barh(y - h / 2 - 0.01, ours, h, color=C_THIS,
            label=f"tron-jax (1 {rows[0].get('device', 'GPU')}, measured)")
    ax.barh(y + h / 2 + 0.01, ref, h, color=C_REF, label="CUDA TRON (paper GPU, published)")
    for yi, v in zip(y, ours):
        ax.text(v + 0.03, yi - h / 2 - 0.01, f"{v:.2f} s", va="center", fontsize=9)
    for yi, v in zip(y, ref):
        ax.text(v + 0.03, yi + h / 2 + 0.01, f"{v:.2f} s", va="center", fontsize=9)
    ax.set_yticks(y, [r["dataset"] for r in rows])
    ax.invert_yaxis()
    ax.set_xlabel("reconstruction time (s) — lower is better")
    ax.set_xlim(0, max(ours + ref) * 1.22)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(frameon=False, loc="lower right", fontsize=9)
    ax.set_title("Radial recon time per dataset class", fontsize=11)
    fig.text(
        0.01,
        0.01,
        "whole_body is the exact reference geometry; the other three are "
        "same-class stand-ins (reference datasets are git-lfs-only).",
        fontsize=7,
        color="#666666",
    )
    fig.tight_layout(rect=(0, 0.04, 1, 1))
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def ssim_table(metrics_csv: str, out_png: str) -> str | None:
    if not os.path.exists(metrics_csv):
        print(f"skip ssim table: {metrics_csv} missing", file=sys.stderr)
        return None
    with open(metrics_csv) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return None
    cols = [c for c in rows[0] if c not in ("label", "frame")]
    plt = _plt()
    fig, ax = plt.subplots(figsize=(1.4 * (len(cols) + 2), 0.32 * len(rows) + 1.2))
    ax.set_axis_off()
    cells = [[r["label"], r["frame"]] + [r.get(c, "") for c in cols] for r in rows]
    tbl = ax.table(
        cellText=cells,
        colLabels=["dataset", "frame"] + cols,
        loc="center",
        cellLoc="center",
    )
    tbl.auto_set_font_size(False)
    tbl.set_fontsize(8)
    tbl.scale(1, 1.3)
    ax.set_title(
        "Accuracy table — recon vs XLA cross-check and exact-DTFT "
        "oracle\n(analog of RUNME4's TRON-vs-IRT SSIM table; reference "
        "TRON scored 0.9965)",
        fontsize=9,
    )
    fig.tight_layout()
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_png


def whole_body_mosaic(ra_path: str, out_png: str, nframes: int = 16) -> str | None:
    if not os.path.exists(ra_path):
        print(f"skip mosaic: {ra_path} missing", file=sys.stderr)
        return None
    from tron_jax.io import ra_read
    from tron_jax.viz import mosaic

    arr = np.asarray(ra_read(ra_path))  # (1, nt, nx, ny, nz)
    stack = np.moveaxis(arr.reshape(arr.shape[-3:]), -1, 0)  # (nz, ny, nx)
    idx = np.linspace(0, stack.shape[0] - 1, min(nframes, stack.shape[0])).astype(int)
    return mosaic(
        np.abs(stack[idx]).transpose(0, 2, 1),
        out_png,
        title=f"whole-body recon, {len(idx)} of {stack.shape[0]} frames",
    )


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--measure", action="store_true", help="re-time the datasets on device")
    p.add_argument("--timings", default=f"{FIGDIR}/timings.csv")
    p.add_argument("--metrics", default="output/dataset_metrics.csv")
    p.add_argument("--mosaic-src", default="output/img_cmt_tron.ra")
    args = p.parse_args()

    os.makedirs(FIGDIR, exist_ok=True)
    if args.measure:
        measure_timings(args.timings)
    elif not os.path.exists(args.timings):
        # never launch full-scale device measurement implicitly — the
        # documented contract is that timing only runs under --measure
        print(
            f"# no {args.timings}; run with --measure (on a GPU) "
            "to time the datasets — skipping timing bars"
        )
    made = [
        timing_bars(args.timings, f"{FIGDIR}/timing_bars.png"),
        ssim_table(args.metrics, f"{FIGDIR}/ssim_table.png"),
        whole_body_mosaic(args.mosaic_src, f"{FIGDIR}/whole_body_mosaic.png"),
    ]
    for m in made:
        if m:
            print(m)


if __name__ == "__main__":
    main()
