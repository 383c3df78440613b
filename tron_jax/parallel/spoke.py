"""Spoke-sharded (sequence-parallel) single-frame reconstruction.

The frame x coil mesh (parallel/mesh.py) scales THROUGHPUT — frames are
embarrassingly parallel (`src/tron.h:49`: the reference's multi-GPU mode has
zero inter-device traffic).  This module scales LATENCY instead: ONE frame's
spokes are sharded across a 'spoke' mesh axis, each device grids its local
subset (gridding is linear over spokes), and a single psum of the partial
oversampled k-space grid completes the adjoint before the cheap, replicated
FFT epilogue.  This is the radial analog of sequence parallelism — the npe
profile axis is the long sequence — and realizes SURVEY.md §5.7's note that
"sequence-like sharding of the npe loop is a psum-reduction over partial
grids" (the only place a ring-style pattern could ever apply here).
Optionally the mesh carries a second 'coil' axis (SP x TP), sharding the
channel batch as well; the coil combine then finishes with the same psum /
gather collectives as the frame x coil mesh.

Collective budget per frame:
  * adjoint recon: ONE psum of the (nxos, nxos) coil grids over 'spoke'
    (+ the coil-combine psum when coils are sharded);
  * CGNR ("pair"/"transpose"): one such psum per A^H W (.) application
    (the CG vectors live in the replicated image domain — alphas/betas need
    no extra spoke reduction; coil-sharded inner products psum over 'coil'
    as in parallel/mesh.py);
  * CGNR --toeplitz: ONE psum of the Fourier multiplier at setup, then the
    iterations are collective-free (two card-local 2n-FFT pairs each).

Padding: npe need not divide the axis — spokes are zero-padded to the mesh
(zero samples grid to zero) and a 0/1 mask zero-weights the padding inside
CGNR's W (solver.cgnr_radial2d sample_mask).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tron_jax.config import ReconConfig
from tron_jax.kernels.kb import kb_beta
from tron_jax.nufft import _adjoint_epilogue, grid_backend, sdc_weights
from tron_jax.solver import cgnr_radial2d
from tron_jax.trajectory import spoke_angles


def make_spoke_mesh(
    n_spoke: int | None = None, n_coil: int = 1, devices=None
) -> Mesh:
    """('spoke',) mesh — or ('spoke', 'coil') when n_coil > 1 — over the
    available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_spoke is None:
        n_spoke = devices.size // n_coil
    assert n_spoke * n_coil <= devices.size, (n_spoke, n_coil, devices.size)
    if n_coil == 1:
        return Mesh(devices[:n_spoke], ("spoke",))
    return Mesh(
        devices[: n_spoke * n_coil].reshape(n_spoke, n_coil), ("spoke", "coil")
    )


def nufft_adjoint_spoke_sharded(
    d_local: jnp.ndarray,
    angles_local: jnp.ndarray,
    cfg: ReconConfig,
    npe_total: int,
    axis_name: str = "spoke",
    apply_sdc: bool = True,
) -> jnp.ndarray:
    """Shard-local adjoint NUFFT inside shard_map: grid this shard's spokes,
    psum the partial oversampled grid over ``axis_name``, run the epilogue.

    d_local: (..., npe_local, nro) — this shard's slice of the frame window
    (zero-padded spokes contribute nothing).  The Ram-Lak weights and the
    reference 1/(nxos*npe) output scale (`src/tron.cu:532`) both use the
    GLOBAL ``npe_total``, so the result equals the unsharded
    nufft.nufft_adjoint of the concatenated window.
    """
    npe_loc, nro = d_local.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)

    if apply_sdc:
        d_local = d_local * sdc_weights(cfg, nro, npe_total).astype(d_local.dtype)
    batch = d_local.shape[:-2]
    flat = d_local.reshape((-1,) + d_local.shape[-2:])
    kgrid = grid_backend(cfg)(flat, angles_local, nxos, cfg.kernwidth, beta)
    # the gridder scaled by 1/(nxos * npe_local); rescale to the global npe
    kgrid = kgrid * (npe_loc / npe_total)
    kgrid = jax.lax.psum(kgrid, axis_name)
    kgrid = kgrid.reshape(batch + (nxos, nxos))
    return _adjoint_epilogue(kgrid, n, cfg, beta)


@functools.lru_cache(maxsize=32)
def _spoke_step(cfg: ReconConfig, mesh: Mesh, nc: int, npe: int, nro: int):
    """Build + jit the spoke-sharded single-frame recon once per
    (config, mesh, shape)."""
    ncs = mesh.shape.get("coil", 1)
    sos = cfg.coil_combine == "sos"

    def worker(d_local, a_local, m_local):
        # d_local: (nc/ncs, npad/ns, nro); a_local/m_local: (npad/ns,)
        if cfg.niter > 0:
            coil = cgnr_radial2d(
                d_local,
                a_local,
                cfg,
                spoke_axis="spoke",
                npe_total=npe,
                sample_mask=m_local,
                reduce_axes=("coil",) if ncs > 1 else (),
            )
        else:
            coil = nufft_adjoint_spoke_sharded(
                d_local, a_local, cfg, npe_total=npe, axis_name="spoke"
            )
        if not sos:
            return coil  # (nc/ncs, n, n); Walsh runs outside (coil gather)
        part = jnp.sum(jnp.abs(coil) ** 2, axis=0)
        if ncs > 1:
            part = jax.lax.psum(part, "coil")
        return jnp.sqrt(part).astype(coil.dtype)

    cspec = "coil" if ncs > 1 else None
    shard = jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=(P(cspec, "spoke", None), P("spoke"), P("spoke")),
        out_specs=P(None, None) if sos else P(cspec, None, None),
        check_vma=False,  # the Pallas gridder's output has no vma type
    )
    step = jax.jit(shard)
    if cfg.coil_combine == "walsh":
        # Walsh needs the full coil covariance: the follow-up jit gathers
        # the coil shards (GSPMD all_gather), as in parallel/mesh.py
        from tron_jax.ops.coil import coil_combine_walsh

        walsh = jax.jit(lambda ci: coil_combine_walsh(ci, cfg.walsh_npatch))
        return lambda d, a, m: walsh(step(d, a, m))
    return step


def recon_window_spoke_sharded(
    window: jnp.ndarray,
    cfg: ReconConfig,
    mesh: Mesh,
    skip: int = 0,
) -> jnp.ndarray:
    """One frame window (nc, npe, nro) reconstructed with its spokes sharded
    over mesh['spoke'] (and channels over mesh['coil'] when present) — the
    low-latency path for a single (or latest) frame.  Returns the combined
    image (n, n) per cfg.coil_combine ("sos" / "walsh") or coil images
    (nc, n, n) ("none").  ``skip`` is the window's global profile offset
    (cfg.skip_angles + frame start), as in trajectory.spoke_angles.

    Matches recon of the unsharded window: gridding is linear over spokes,
    so the partial grids psum to the full one; CGNR solves the identical
    global weighted least-squares problem (see solver.cgnr_radial2d's
    spoke_axis contract).
    """
    nc, npe, nro = window.shape
    ns = mesh.shape["spoke"]
    ncs = mesh.shape.get("coil", 1)
    assert nc % ncs == 0, f"nc={nc} must divide over coil axis {ncs}"
    npad = -(-npe // ns) * ns
    scheme = cfg.scheme_for("adjoint")
    # linear schemes derive angles from the GLOBAL npe, so the padded angle
    # array is built here and sharded in (golden angles are index-based and
    # simply continue; padded spokes carry zero data and zero CGNR weight)
    if scheme == "golden" or npad == npe:
        angles = spoke_angles(npad, scheme, cfg.skip_angles + skip)
    else:
        angles = spoke_angles(npe, scheme, cfg.skip_angles + skip)
        angles = jnp.concatenate([angles, jnp.zeros(npad - npe, angles.dtype)])
    mask = (jnp.arange(npad) < npe).astype(jnp.float32)
    if npad != npe:
        window = jnp.concatenate(
            [window, jnp.zeros((nc, npad - npe, nro), window.dtype)], axis=1
        )
    step = _spoke_step(cfg, mesh, nc, npe, nro)
    return step(window, angles, mask)
