"""Smoke tests for the paper-figure pipeline (scripts/paper_plots.py) — the
rebuild of the reference's figure layer (`src/paper_plots.m`,
`src/whole_body_mosaic.m`, RUNME4's timing/SSIM outputs).

Rendering only (no device timing): feed fixture CSVs / a tiny .ra stack and
assert the PNGs materialize.  The --measure path is exercised on hardware by
the RUNME pipelines.
"""

import csv
import importlib.util
import os
import sys

import numpy as np
import pytest

pytest.importorskip("matplotlib")

_SPEC = importlib.util.spec_from_file_location(
    "paper_plots",
    os.path.join(os.path.dirname(__file__), "..", "scripts", "paper_plots.py"),
)
paper_plots = importlib.util.module_from_spec(_SPEC)
sys.modules["paper_plots"] = paper_plots
_SPEC.loader.exec_module(paper_plots)


def _write_timings(path):
    rows = [
        {
            "dataset": "whole_body",
            "frames": 956,
            "seconds": 1.0,
            "ref_gpu_s": 3.28,
            "speedup": 3.28,
            "msamples_per_s": 100.0,
            "device": "test card",
        },
        {
            "dataset": "optic_nerve",
            "frames": 17,
            "seconds": 0.1,
            "ref_gpu_s": 0.32,
            "speedup": 3.2,
            "msamples_per_s": 10.0,
            "device": "test card",
        },
    ]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_timing_bars(tmp_path):
    csv_path = tmp_path / "timings.csv"
    _write_timings(csv_path)
    out = paper_plots.timing_bars(str(csv_path), str(tmp_path / "bars.png"))
    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_ssim_table(tmp_path):
    csv_path = tmp_path / "metrics.csv"
    with open(csv_path, "w", newline="") as fh:
        w = csv.DictWriter(
            fh, fieldnames=["label", "frame", "ssim", "nmse", "oracle_nrmse"]
        )
        w.writeheader()
        w.writerow(
            {
                "label": "whole_body",
                "frame": 400,
                "ssim": 0.999999,
                "nmse": 1e-7,
                "oracle_nrmse": 4e-4,
            }
        )
    out = paper_plots.ssim_table(str(csv_path), str(tmp_path / "tbl.png"))
    assert out is not None and os.path.getsize(out) > 0


def test_ssim_table_missing_csv(tmp_path):
    assert (
        paper_plots.ssim_table(str(tmp_path / "nope.csv"), str(tmp_path / "t.png"))
        is None
    )


def test_whole_body_mosaic(tmp_path):
    from tron_jax.io import ra_write

    # tiny (1, nt, nx, ny, nz) recon stack in the CLI's output convention
    nz, n = 5, 16
    img = (np.random.default_rng(0).standard_normal((1, 1, n, n, nz))).astype(
        np.complex64
    )
    ra_path = tmp_path / "img.ra"
    ra_write(img, str(ra_path))
    out = paper_plots.whole_body_mosaic(
        str(ra_path), str(tmp_path / "mosaic.png"), nframes=4
    )
    assert out is not None and os.path.getsize(out) > 0
