"""Multi-process smoke test: two real processes, a local coordinator, and
the global frames-across-processes x coils-within-a-process mesh of
tron_jax.parallel.distributed — the SURVEY §5.8 blueprint exercised on the
CPU (each process contributes 4 virtual CPU devices).

Each worker reconstructs the same acquisition through the sharded path and
asserts its addressable output shards equal the single-device recon —
i.e. the psum'd SoS combine and the frame partition survive a real process
boundary, not just the single-process fallback.
"""

import os
import socket
import subprocess
import sys
import textwrap


_WORKER = textwrap.dedent(
    """
    import os, sys

    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_device_count()
    assert jax.device_count() == 4 * nproc, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental import multihost_utils

    from tron_jax.config import ReconConfig
    from tron_jax.parallel import distributed, recon_frames_sharded
    from tron_jax.recon import recon_frames

    mesh = distributed.make_global_mesh(n_coil=2)
    assert mesh.shape["frame"] * mesh.shape["coil"] == 8

    cfg = ReconConfig(
        golden_angle=True, data_undersamp=0.5, prof_slide=4, adjoint=True
    )
    nc, nro, slide, nz = 4, 32, 4, 7
    work = cfg.npe1work(nro, 10**9)
    npe1 = work + (nz - 1) * slide
    rng = np.random.default_rng(0)  # same seed on every process: replicated
    data = (
        rng.standard_normal((nc, npe1, nro))
        + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)

    gdata = multihost_utils.host_local_array_to_global_array(data, mesh, P())
    out = recon_frames_sharded(gdata, cfg, mesh, work, slide, nz)

    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    checked = 0
    for sh in out.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(sh.data), want[sh.index], rtol=2e-4, atol=2e-5
        )
        checked += 1
    assert checked > 0
    print(f"DCN-OK pid={pid} shards={checked}", flush=True)
    """
)


def test_two_process_dcn_recon(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / "dcn_worker.py"
    worker.write_text(_WORKER)

    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", coord],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"DCN-OK pid={i}" in out, out[-2000:]
