#!/usr/bin/env python
"""Bring-up check on the GPU: drive the main path through the entry points a
user calls, at the width of the reference's whole-body acquisition, and
check what comes out.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card, one process, each phase raises on failure:
  1. device    the JAX devices, and the card's name and power limit
  2. fixture   the whole-body acquisition (6 coils, 512 readouts, 20,271
               golden-angle profiles) synthesized into a temporary directory
  3. adjoint   `tron -a -G -u 0.4 -d 21`, in memory, direct and
               --incremental: 956 finite frames of 256^2, the two within
               1e-4 worst-frame NRMSE
  4. stream    the same recon with --stream --half, equal to phase 3 within
               the fp16 rounding of its output
  5. roundtrip phantom forward, then adjoint (--scheme linear_half), at
               n = 256: magnitude correlation with the phantom > 0.9
  6. cgnr      10 iterations, pair and --toeplitz, on a short
               swallowing-class series: the data residual falls, and both
               come closer to the phantom than the plain adjoint
  7. parity    the gpu-marked tests (kernels vs their plain references at
               real widths), run in this process
--four runs `tron ... --shard` (direct and --incremental) on a 4 x 1
('frame', 'coil') mesh and one `--shard-spokes -i 10` window, each against
the one-card result of the same recon (rtol 2e-4).

The last line of the output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WHOLE_BODY = ["-a", "-G", "-u", "0.4", "-d", "21"]


def card() -> str:
    """nvidia-smi's name and power limit, from a process that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def log(*a):
    print(*a, flush=True)


class Phase:
    """Times a phase and names it in the error that escapes it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, err, tb):
        dt = time.perf_counter() - self.t0
        log(f"[{self.name}] {'ok' if kind is None else 'FAILED'} in {dt:.1f} s")


def nrmse(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def frames_of(path):
    """A CLI adjoint output (.ra dims (1, 1, nx, ny, nz), complex or fp16
    re/im pairs) as (nz, ny, nx) complex64."""
    import numpy as np

    from tron_jax.io import ra_read

    a = ra_read(path)
    if a.dtype == np.float16:
        a = a[0].astype(np.float32) + 1j * a[1].astype(np.float32)
    return np.transpose(a[0, 0], (2, 1, 0)).astype(np.complex64)


def tron(*argv):
    from tron_jax import cli

    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"tron {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def magnitude_error(frames, truth):
    """Mean over frames of the best-scale magnitude NRMSE vs |truth|."""
    import numpy as np

    t = np.abs(truth)
    errs = []
    for f in np.abs(frames):
        s = float(np.vdot(f, t).real / max(np.vdot(f, f).real, 1e-30))
        errs.append(np.linalg.norm(s * f - t) / np.linalg.norm(t))
    return float(np.mean(errs))


def whole_body_fixture(tmp, npe=20271):
    from tron_jax.tools import make_goldenangle

    path = os.path.join(tmp, f"whole_body_{npe}.ra")
    make_goldenangle.main([path, "--nc", "6", "--nro", "512", "--npe", str(npe)])
    return path


def one_card(tmp):
    import numpy as np

    with Phase("fixture"):
        wb = whole_body_fixture(tmp)
        log(f"fixture: {os.path.getsize(wb) / 1e6:.0f} MB")

    with Phase("adjoint"):
        direct = os.path.join(tmp, "direct.ra")
        inc = os.path.join(tmp, "incremental.ra")
        log(f"adjoint direct: {tron(*WHOLE_BODY, wb, direct):.2f} s wall (cold)")
        log(f"adjoint direct: {tron(*WHOLE_BODY, wb, direct):.2f} s wall (warm)")
        log(f"adjoint incremental: "
            f"{tron(*WHOLE_BODY, '--incremental', wb, inc):.2f} s wall (cold)")
        log(f"adjoint incremental: "
            f"{tron(*WHOLE_BODY, '--incremental', wb, inc):.2f} s wall (warm)")
        a, b = frames_of(direct), frames_of(inc)
        for name, x in (("direct", a), ("incremental", b)):
            if x.shape != (956, 256, 256) or not np.isfinite(x).all():
                raise AssertionError(f"{name}: shape {x.shape}, or not finite")
        worst = max(nrmse(b[z], a[z]) for z in range(a.shape[0]))
        log(f"incremental vs direct: worst-frame nrmse {worst:.3e} (956 frames)")
        if worst > 1e-4:
            raise AssertionError(f"incremental vs direct {worst:.3e} > 1e-4")
        log(f"peak_bytes_in_use: {peak_bytes()}")

    with Phase("stream"):
        streamed = os.path.join(tmp, "stream.ra")
        log(f"adjoint --stream --half: "
            f"{tron(*WHOLE_BODY, '--stream', '--half', wb, streamed):.2f} s wall")
        s = frames_of(streamed)
        bound = np.abs(a) * 2.0 ** -10 + 6e-8 + 1e-6 * np.abs(a).max()
        excess = float(np.max(np.abs(s - a) - bound))
        log(f"stream vs in-memory: nrmse {nrmse(s, a):.3e}, "
            f"max excess over the fp16 bound {excess:.3e}")
        if s.shape != a.shape or excess > 0:
            raise AssertionError("streamed recon differs beyond fp16 rounding")
        os.remove(wb)

    with Phase("roundtrip"):
        from tron_jax.phantom import shepp_logan
        from tron_jax.tools import make_phantom

        sl = os.path.join(tmp, "sl.ra")
        sl_data = os.path.join(tmp, "sl_data.ra")
        sl_img = os.path.join(tmp, "sl_img.ra")
        make_phantom.main([sl, "--n", "256"])
        log(f"forward: {tron(sl, sl_data):.2f} s wall")
        log(f"adjoint: {tron('-a', '--scheme', 'linear_half', sl_data, sl_img):.2f} s")
        img = frames_of(sl_img)[0]
        corr = float(np.corrcoef(np.abs(img).ravel(),
                                 np.abs(shepp_logan(256)).ravel())[0, 1])
        log(f"roundtrip magnitude correlation with the phantom: {corr:.4f}")
        if corr <= 0.9:
            raise AssertionError(f"correlation {corr:.4f} <= 0.9")

    with Phase("cgnr"):
        cgnr_phase(tmp)

    with Phase("parity"):
        import pytest

        os.environ["TRON_GPU_TESTS"] = "1"
        rc = pytest.main([
            os.path.join(HERE, "tests"), "-m", "gpu", "-q", "-s",
            "-p", "no:xdist", "-p", "no:cacheprovider", "-p", "no:randomly",
            "--rootdir", HERE,
        ])
        if rc != 0:
            raise AssertionError(f"gpu-marked tests: pytest exited {rc}")


def cgnr_phase(tmp):
    """Swallowing-class series (4 coils, 256 readouts, -u 0.5 -d 21: 128
    spokes per 128^2 frame) with 16 frames."""
    import jax.numpy as jnp
    import numpy as np

    from tron_jax.config import ReconConfig
    from tron_jax.io import ra_read
    from tron_jax.nufft import nufft_forward, sdc_weights
    from tron_jax.phantom import shepp_logan
    from tron_jax.solver import cgnr_radial2d
    from tron_jax.tools import make_goldenangle
    from tron_jax.trajectory import spoke_angles

    npe = 128 + 15 * 21
    path = os.path.join(tmp, "swallow.ra")
    make_goldenangle.main([path, "--nc", "4", "--nro", "256", "--npe", str(npe)])
    args = ["-a", "-G", "-u", "0.5", "-d", "21"]
    truth = shepp_logan(128)
    errs = {}
    for name, extra in (("adjoint", []), ("pair", ["-i", "10"]),
                        ("toeplitz", ["-i", "10", "--toeplitz"])):
        out = os.path.join(tmp, f"swallow_{name}.ra")
        log(f"cgnr series {name}: {tron(*args, *extra, path, out):.2f} s wall")
        errs[name] = magnitude_error(frames_of(out), truth)
        log(f"cgnr series {name}: nrmse vs phantom {errs[name]:.4f}")
    for name in ("pair", "toeplitz"):
        if not errs[name] < errs["adjoint"]:
            raise AssertionError(f"{name} CGNR no closer to the phantom")

    # data residual of frame 0 after 0, 1, 3 and 10 iterations (pair mode)
    raw = ra_read(path)                               # (nc, 1, nro, npe, 1)
    data = jnp.asarray(np.transpose(raw[:, 0, :, :128, 0], (0, 2, 1)))
    cfg = ReconConfig(golden_angle=True)
    angles = spoke_angles(128, "golden", 0)
    w = jnp.sqrt(sdc_weights(cfg, 256, 128).at[0].set(0))
    res = []
    for k in (1, 3, 10):
        x = cgnr_radial2d(data, angles, cfg, niter=k, rtol=0.0)
        r = nufft_forward(x, angles, cfg, nro=256, wrap=False) - data
        res.append(float(jnp.linalg.norm(w * r) / jnp.linalg.norm(w * data)))
    log(f"cgnr pair frame 0: weighted data residual after 1/3/10 iterations "
        f"{res[0]:.4f} / {res[1]:.4f} / {res[2]:.4f}")
    if not res[0] > res[1] > res[2]:
        raise AssertionError("CGNR data residual does not fall")


def four_cards(tmp):
    import numpy as np

    with Phase("fixture"):
        wb = whole_body_fixture(tmp)
        window = whole_body_fixture(tmp, npe=204)

    with Phase("shard"):
        for extra in ([], ["--incremental"]):
            one = os.path.join(tmp, "one.ra")
            four = os.path.join(tmp, "four.ra")
            log(f"one card {extra}: {tron(*WHOLE_BODY, *extra, wb, one):.2f} s wall")
            log(f"--shard {extra}: "
                f"{tron(*WHOLE_BODY, *extra, '--shard', wb, four):.2f} s wall (cold)")
            log(f"--shard {extra}: "
                f"{tron(*WHOLE_BODY, *extra, '--shard', wb, four):.2f} s wall (warm)")
            a, b = frames_of(one), frames_of(four)
            log(f"--shard {extra} vs one card: nrmse {nrmse(b, a):.3e}")
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4 * np.abs(a).max())

    with Phase("shard-spokes"):
        one = os.path.join(tmp, "win_one.ra")
        four = os.path.join(tmp, "win_four.ra")
        cgnr = ["-a", "-G", "-u", "0.4", "-i", "10"]
        log(f"one card -i 10: {tron(*cgnr, window, one):.2f} s wall")
        log(f"--shard-spokes -i 10: "
            f"{tron(*cgnr, '--shard-spokes', window, four):.2f} s wall")
        a, b = frames_of(one), frames_of(four)
        log(f"--shard-spokes vs one card: nrmse {nrmse(b, a):.3e}")
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4 * np.abs(a).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded paths only")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "tron_jax")):
        print("error: chip_smoke.py runs from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    with Phase("device"):
        name_power = card()
        import jax

        from tron_jax.utils import enable_compilation_cache

        log(f"compile cache: {enable_compilation_cache()}")
        devices = jax.devices()
        log(f"devices: {devices}")
        if devices[0].platform != "gpu":
            print(f"error: no GPU (platform {devices[0].platform!r})",
                  file=sys.stderr)
            return 1
        want = 4 if args.four else 1
        if len(devices) < want:
            print(f"error: {want} GPUs needed, {len(devices)} found",
                  file=sys.stderr)
            return 1
    with tempfile.TemporaryDirectory() as tmp:
        (four_cards if args.four else one_card)(tmp)
    d = jax.devices()[0]
    log(f"card: {name_power}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
