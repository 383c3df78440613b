"""Multi-card sharding: frames x coils over a 2D device mesh.

The scaling story (SURVEY.md §5.7-5.8): frames are the long axis of a
golden-angle acquisition and are embarrassingly parallel -> pure data
parallelism over the 'frame' mesh axis.  Coils shard over the 'coil' axis;
the only cross-card communication in the whole recon is the psum that
completes the sum-of-squares coil combine — it rides NVLink (the cards of
one host are joined all to all), everything else is card-local (per-frame FFTs stay unsharded by design; at <=512^2 a
sharded single-image FFT would just buy all-to-all transposes).

The profile stream is replicated along 'frame' (windows overlap when
prof_slide < npe1work, so a clean frame-shard of the input does not exist);
at 500 MB for the largest reference dataset this is well within device
memory.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tron_jax.config import ReconConfig
from tron_jax.nufft import nufft_adjoint
from tron_jax.solver import cgnr_radial2d
from tron_jax.trajectory import spoke_angles


def make_mesh(
    n_frame: int | None = None,
    n_coil: int = 1,
    devices=None,
) -> Mesh:
    """Create a ('frame', 'coil') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_frame is None:
        n_frame = devices.size // n_coil
    assert n_frame * n_coil == devices.size, (n_frame, n_coil, devices.size)
    return Mesh(devices.reshape(n_frame, n_coil), ("frame", "coil"))


import functools


@functools.lru_cache(maxsize=32)
def _sharded_step(cfg, mesh, npe1work, prof_slide, nz, nc, npe1, nro):
    """Build + jit the shard_mapped recon once per (config, mesh, shape) —
    repeated calls (e.g. the CLI's nt > 1 repetition loop) reuse the
    compiled executable instead of retracing a fresh closure."""
    nfr = mesh.shape["frame"]
    ncs = mesh.shape["coil"]
    nzp = -(-nz // nfr) * nfr  # pad frame count to the mesh

    from tron_jax.recon import incremental_applicable

    use_inc = cfg.incremental and incremental_applicable(
        cfg, npe1work, prof_slide, nz
    )

    def worker(d_local: jnp.ndarray, skip0: jnp.ndarray) -> jnp.ndarray:
        # d_local: (nc/ncs, npe1, nro); all frames' windows come from the
        # replicated-in-'frame' profile stream via dynamic_slice.  skip0 is
        # the traced global profile offset of d_local[..., 0, :] (nonzero
        # when the streaming driver feeds blocks of a huge acquisition).
        fid = jax.lax.axis_index("frame")
        per = nzp // nfr

        if use_inc:
            # per-shard telescoping (recon.incremental_scan): each shard's
            # frame range is contiguous, so it grids its first window once
            # and advances by signed 2*slide-spoke deltas; the pad tail
            # reads clamped windows whose outputs the caller slices off
            from tron_jax.kernels.kb import kb_beta
            from tron_jax.nufft import _adjoint_epilogue, grid_backend, sdc_weights
            from tron_jax.recon import incremental_scan

            n = nro // 2
            nxos = int(n * cfg.gridos)
            beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
            scheme = cfg.scheme_for("adjoint")
            src = d_local * sdc_weights(cfg, nro, npe1work).astype(d_local.dtype)
            backend = grid_backend(cfg)

            def gridw(win, ang):
                return backend(win, ang, nxos, cfg.kernwidth, beta)

            def window(pe0, m):
                return jax.lax.dynamic_slice_in_dim(src, pe0, m, axis=-2)

            def angles_of(pe0, m):
                return spoke_angles(m, scheme, cfg.skip_angles + skip0 + pe0)

            def frame_image(kg):
                coilimg = _adjoint_epilogue(kg, n, cfg, beta)
                if cfg.coil_combine != "sos":
                    return coilimg
                part = jnp.sum(jnp.abs(coilimg) ** 2, axis=0)
                total = jax.lax.psum(part, "coil")
                return jnp.sqrt(total).astype(coilimg.dtype)

            return incremental_scan(
                window, angles_of, gridw, frame_image,
                npe1work, prof_slide, per, z0=fid * per, block=cfg.inc_block,
            )

        def one(i):
            z = fid * per + i
            zc = jnp.minimum(z, nz - 1)  # padded tail recomputes last frame
            pe0 = zc * prof_slide
            angles = spoke_angles(
                npe1work, cfg.scheme_for("adjoint"), cfg.skip_angles + skip0 + pe0
            )
            if cfg.niter > 0:
                # CG inner products must be global across the coil shards
                win = jax.lax.dynamic_slice_in_dim(
                    d_local, pe0, npe1work, axis=-2
                )
                coilimg = cgnr_radial2d(
                    win, angles, cfg, reduce_axes=("coil",) if ncs > 1 else (),
                )
            else:
                win = jax.lax.dynamic_slice_in_dim(
                    d_local, pe0, npe1work, axis=-2
                )
                coilimg = nufft_adjoint(win, angles, cfg)
            if cfg.coil_combine != "sos":
                return coilimg                       # (nc/ncs, n, n)
            # partial SoS + psum over the coil shards
            part = jnp.sum(jnp.abs(coilimg) ** 2, axis=0)
            total = jax.lax.psum(part, "coil")
            return jnp.sqrt(total).astype(coilimg.dtype)

        return jax.lax.map(
            one, jnp.arange(per), batch_size=min(per, cfg.frame_block)
        )

    sos = cfg.coil_combine == "sos"
    # check_vma=False: the Pallas gridder's output carries no varying-axes
    # type, so shard_map could not check it
    shard = jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=(P("coil", None, None), P()),
        out_specs=(
            P("frame", None, None) if sos else P("frame", "coil", None, None)
        ),
        check_vma=False,
    )
    step = jax.jit(shard)
    if cfg.coil_combine == "walsh":
        # Walsh needs the full coil covariance, so it runs in a follow-up
        # jit over the (frame-sharded, coil-sharded) coil images — GSPMD
        # inserts the coil all_gather; frames stay data-parallel.  (Kept
        # outside shard_map: XLA:CPU's fft thunk rejects the layouts that
        # a manual in-shard gather + eigen-iteration forces onto the IFFT.)
        from tron_jax.ops.coil import coil_combine_walsh

        # frames are sharded over 'frame' here, so a plain vmap keeps frame
        # parallelism (a lax.map chunk would serialize the sharded axis);
        # per-device peak memory is nz/ndev frames of Hermitian-unique
        # covariance planes.
        walsh = jax.jit(
            jax.vmap(lambda ci: coil_combine_walsh(ci, cfg.walsh_npatch)),
            out_shardings=jax.sharding.NamedSharding(mesh, P("frame", None, None)),
        )
        return lambda d, s: walsh(step(d, s))
    return step


def recon_frames_sharded(
    data: jnp.ndarray,
    cfg: ReconConfig,
    mesh: Mesh,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """Sharded sliding-window recon. data: (nc, npe1, nro) -> (nz, n, n).

    ``skip0`` is a traced global profile offset of data[..., 0, :] within
    the full acquisition (recon.recon_frames contract) — the streaming
    driver feeds overlapping disk blocks through one compiled sharded
    program by varying it.

    Frames are partitioned across the 'frame' axis, channels across 'coil';
    each device reconstructs its local (frames x coils) block and the coil
    combine finishes over the 'coil' axis per cfg.coil_combine:

      * "sos" — partial sum-of-squares + psum (one scalar-image allreduce,
        the cheapest possible collective);
      * "walsh" — all_gather of the coil shards (Walsh's eigenvector filter
        needs the full coil covariance), then the local Walsh combine;
      * "none" — coil images returned with the channel axis still sharded
        over 'coil' (output (nz, nc, n, n)).
    """
    nc, npe1, nro = data.shape
    ncs = mesh.shape["coil"]
    assert nc % ncs == 0, f"nc={nc} must divide over coil axis {ncs}"
    step = _sharded_step(cfg, mesh, npe1work, prof_slide, nz, nc, npe1, nro)
    return step(data, jnp.asarray(skip0, jnp.int32))[:nz]


@functools.lru_cache(maxsize=16)
def _koosh_sharded_step(cfg2, mesh, work, slide, nzi, nt, nc, npe1, nro, npe2):
    """Build + jit the slice-sharded koosh adjoint once per (config, mesh,
    shape).  The kz IFFT mixes all npe2 values per sample, so it runs
    replicated (cheap: one batched 1-D FFT) and only the per-slice 2D
    recons shard; a padded tail recomputes the last slice, like the frame
    scheduler."""
    from tron_jax.recon import recon_frames

    nfr = mesh.shape["frame"]
    per = -(-npe2 // nfr)

    def worker(d_rep):
        # d_rep: (nt*nc, npe1, nro, npe2), replicated
        sl = jnp.fft.fftshift(
            jnp.fft.ifft(jnp.fft.ifftshift(d_rep, axes=-1), axis=-1), axes=-1
        ) * npe2
        sl = jnp.moveaxis(sl, -1, 0).reshape(npe2, nt, nc, npe1, nro)
        fid = jax.lax.axis_index("frame")

        def one(i):
            z = jnp.minimum(fid * per + i, npe2 - 1)
            sd = jax.lax.dynamic_index_in_dim(sl, z, axis=0, keepdims=False)
            return jax.lax.map(
                lambda dd: recon_frames(dd, cfg2, work, slide, nzi), sd
            )  # (nt, nzi, [nc,] n, n)

        return jax.lax.map(one, jnp.arange(per))

    rank = 5 + (1 if cfg2.coil_combine == "none" else 0)
    shard = jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=P(None, None, None, None),
        out_specs=P("frame", *([None] * (rank - 1))),
        check_vma=False,  # the Pallas gridder's output has no vma type
    )

    def post(out):
        # (npe2p, nt, nzi, [nc,] n, n) -> (npe2*nzi, nt, [nc,] n, n)
        out = out[:npe2]
        out = jnp.moveaxis(out, 2, 1)
        return out.reshape((npe2 * nzi, nt) + out.shape[3:])

    return jax.jit(lambda d: post(shard(d)))


def recon_stack_of_stars_sharded(
    indata: np.ndarray, cfg: ReconConfig, mesh: Mesh
) -> np.ndarray:
    """Slice-sharded 3D stack-of-stars adjoint: the npe2 (kz) slices are
    embarrassingly parallel after the kz IFFT — like frames — so they shard
    over the 'frame' mesh axis with zero inter-card communication.
    indata: 5-D .ra layout (nc, nt, nro, npe1, npe2); returns
    (npe2*nzi, nt, [nc,] n, n), matching recon_radial2d's koosh adjoint."""
    import dataclasses

    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    nc, nt, nro, npe1, npe2 = indata.shape[:5]
    work, slide, nzi = cfg2.frame_geometry(nro, npe1)
    dnp = np.ascontiguousarray(
        np.transpose(np.asarray(indata), (1, 0, 3, 2, 4))
    ).reshape(nt * nc, npe1, nro, npe2)
    step = _koosh_sharded_step(
        cfg2, mesh, work, slide, nzi, nt, nc, npe1, nro, npe2
    )
    return np.asarray(step(jnp.asarray(dnp)))


@functools.lru_cache(maxsize=16)
def _forward_sharded_step(cfg, mesh, npe1, nro, nz, nC, ny, nx, koosh):
    """Build + jit the frame(+coil)-sharded forward degrid once per
    (config, mesh, shape).  Image slices degrid independently (the hot
    O(nro*npe*(2kw)^2) work, `src/tron.cu:540-577`), so they shard over
    'frame' with zero communication — channels likewise over 'coil'.  For
    -3 (koosh) the trailing centered kz FFT mixes all slices, so it runs
    AFTER the sharded degrids under the same jit: XLA inserts the one
    all_gather of the (cheap, already-degridded) sample stack."""
    nfr = mesh.shape["frame"]
    nzp = -(-nz // nfr) * nfr
    scheme = cfg.scheme_for("forward")
    from tron_jax.nufft import nufft_forward

    def worker(stack_local):
        # stack_local: (nzp/nfr, nC/ncs, ny, nx)
        angles = spoke_angles(npe1, scheme, cfg.skip_angles)
        return jax.lax.map(
            lambda zimg: nufft_forward(zimg, angles, cfg, nro=nro),
            stack_local,
            batch_size=min(stack_local.shape[0], cfg.frame_block),
        )

    shard = jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=P("frame", "coil", None, None),
        out_specs=P("frame", "coil", None, None),
    )

    def run(stack):
        pad = nzp - nz
        if pad:
            # pad tail redundantly degrids the last slice; sliced off below
            stack = jnp.concatenate(
                [stack, jnp.broadcast_to(stack[-1:], (pad, nC, ny, nx))], 0
            )
        data = shard(stack)[:nz]                   # (nz, nC, npe1, nro)
        if koosh:
            data = jnp.moveaxis(data, 0, -1)
            kz = jnp.fft.fftshift(
                jnp.fft.fft(jnp.fft.ifftshift(data, axes=-1), axis=-1), axes=-1
            )
            return jnp.moveaxis(kz, -1, 0)         # (npe2, nC, npe1, nro)
        return data

    return jax.jit(run)


def recon_forward_sharded(
    indata: np.ndarray, cfg: ReconConfig, mesh: Mesh
) -> np.ndarray:
    """Frame(+coil)-sharded forward degrid (2D series and -3 stacks).

    indata: image .ra layout (nc, nt, nx, ny, nz); returns
    (nz, nc, nt, npe1, nro), matching recon_radial2d's forward path
    (`tron_jax/recon.py` forward branches).  nc*nt must divide over the
    'coil' mesh axis; a non-dividing nz pads over 'frame' (redundant
    degrids of the last slice, sliced off on return)."""
    import dataclasses

    koosh = bool(cfg.koosh)
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0) if koosh else cfg
    nc, nt, nx, ny, nz = indata.shape[:5]
    nro = int(cfg2.gridos * nx)
    npe1 = int(cfg2.data_undersamp * nro)
    ncs = mesh.shape["coil"]
    assert (nc * nt) % ncs == 0, f"nc*nt={nc*nt} must divide over coil axis {ncs}"
    imgs_np = np.ascontiguousarray(
        np.transpose(np.asarray(indata), (4, 0, 1, 3, 2))
    ).reshape(nz, nc * nt, ny, nx)
    step = _forward_sharded_step(cfg2, mesh, npe1, nro, nz, nc * nt, ny, nx, koosh)
    out = np.asarray(step(jnp.asarray(imgs_np)))
    return out.reshape(nz, nc, nt, npe1, nro)
