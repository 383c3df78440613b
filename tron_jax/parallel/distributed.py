"""Multi-process extension of the frame-parallel recon.

SURVEY.md §5.8: the reference's MULTI_GPU mode round-robins frames over the
GPUs of ONE host with zero inter-device traffic (`src/tron.h:49`).  The mesh
generalizes this across processes and hosts: the 'frame' axis spans them
because frames never communicate, and the 'coil' axis stays inside one
process, whose cards are joined all to all by NVLink, where its psum /
all_gather collectives are cheap.

Usage (one process per host, JAX's distributed bootstrap; the coordinator
address, process count and process id are given explicitly):

    from tron_jax.parallel import distributed
    distributed.initialize(coordinator_address="host0:1234",
                           num_processes=2, process_id=0)
    mesh = distributed.make_global_mesh(n_coil=2)
    out = recon_frames_sharded(data, cfg, mesh, work, slide, nz)

Every process feeds the same replicated profile stream (or its own copy of
the file — the stream is replicated along 'frame' by in_specs, so feeding
identical host arrays is correct and costs no cross-host traffic at
dispatch).  Single-process meshes are exactly `make_mesh`, so all of this
is a no-op on one host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(**kwargs) -> None:
    """jax.distributed.initialize passthrough (coordinator_address,
    num_processes, process_id).  Idempotent."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def make_global_mesh(n_coil: int = 1) -> Mesh:
    """('frame', 'coil') mesh over ALL processes' devices.

    Device order: jax.devices() globally — contiguous per process, so the
    'frame' axis splits across processes (pure data parallelism, no
    cross-process collectives) while each process' local cards fill 'coil'
    sub-groups (psum/all_gather over NVLink).  Requires n_coil to divide the
    per-process device count so no coil group straddles a process.
    """
    devs = np.asarray(jax.devices())
    local = jax.local_device_count()
    if n_coil > 1:
        assert local % n_coil == 0, (
            f"n_coil={n_coil} must divide local device count {local} so coil "
            "collectives stay inside one process"
        )
    n_frame = devs.size // n_coil
    return Mesh(devs.reshape(n_frame, n_coil), ("frame", "coil"))


def process_frame_slice(nz: int, n_coil: int = 1) -> slice:
    """The frame indices this process' devices own under make_global_mesh —
    for feeding per-host file reads (io.native.ra_read_profiles windows)
    instead of a fully replicated stream.

    Matches recon_frames_sharded's partition exactly: each frame-device
    owns per = ceil(nz_padded / n_frame) consecutive frames, and process i
    holds frame-devices [i*fd, (i+1)*fd) with fd = local_devices / n_coil.
    """
    local = jax.local_device_count()
    n_frame = jax.device_count() // n_coil
    fd = local // n_coil                  # frame-devices per process
    per = -(-nz // n_frame)               # frames per frame-device (padded)
    i = jax.process_index()
    return slice(min(i * fd * per, nz), min((i + 1) * fd * per, nz))
