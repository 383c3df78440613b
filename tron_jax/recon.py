"""Reconstruction driver: sliding-window frame scheduling over radial data.

The reference round-robins frames onto two CUDA streams
(`src/tron.cu:726-786`); here frames become a batch axis —
extracted from the profile stream by dynamic-slice gather, reconstructed
under one jit (lax.map over frame chunks so the compiled shape is
frame-count independent), and sharded across cards via shard_map in
`tron_jax.parallel` (frames are embarrassingly parallel; the reference's
MULTI_GPU mode had zero inter-device traffic, `src/tron.h:49`).  The
streaming drivers below overlap disk reads, uploads, compute and readback,
as the reference's streams do.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tron_jax.config import ReconConfig
from tron_jax.nufft import nufft_adjoint, nufft_forward
from tron_jax.ops.coil import coil_combine_sos, coil_combine_walsh
from tron_jax.solver import cgnr_radial2d
from tron_jax.trajectory import spoke_angles


def _fetch_host(dev: jnp.ndarray, half: bool) -> np.ndarray:
    """Device images -> host complex64.  ``half`` casts to float16 re/im
    planes ON DEVICE before the transfer (2x fewer D2H bytes) and
    recombines on host — value-identical to a later host-side --half store
    (the f16 -> f32 -> f16 roundtrip is exact), so it is only enabled when
    the caller stores float16 anyway."""
    if half:
        from tron_jax.utils.xfer import to_host_planes

        re, im = to_host_planes(dev, np.float16)
        return (
            re.astype(np.float32) + 1j * im.astype(np.float32)
        ).astype(np.complex64)
    return np.asarray(dev)


def _combine(coilimg: jnp.ndarray, cfg: ReconConfig) -> jnp.ndarray:
    if cfg.coil_combine == "walsh":
        return coil_combine_walsh(coilimg, cfg.walsh_npatch)
    if cfg.coil_combine == "sos":
        return coil_combine_sos(coilimg, axis=0)
    return coilimg


def reconstruct_frame(
    data_window: jnp.ndarray,
    skip: jnp.ndarray,
    cfg: ReconConfig,
) -> jnp.ndarray:
    """One frame: (nc, npe1work, nro) -> combined image (n, n).

    ``skip`` is the global profile offset of this frame (skip_angles +
    z*prof_slide), a traced scalar so frames can vmap.
    """
    npe = data_window.shape[-2]
    angles = spoke_angles(npe, cfg.scheme_for("adjoint"), skip)
    if cfg.niter > 0:
        coilimg = cgnr_radial2d(data_window, angles, cfg)
    else:
        coilimg = nufft_adjoint(data_window, angles, cfg)
    return _combine(coilimg, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "npe1work", "prof_slide", "nz"))
def recon_frames(
    data: jnp.ndarray,
    cfg: ReconConfig,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """All frames on one device. data: (nc, npe1, nro) -> (nz, n, n).

    ``skip0`` is a *traced* global profile offset of data[..., 0, :] within
    the full acquisition — the streaming driver feeds overlapping blocks of
    a huge file through one compiled program by varying it."""

    def one(z):
        pe0 = z * prof_slide
        win = jax.lax.dynamic_slice_in_dim(data, pe0, npe1work, axis=-2)
        return reconstruct_frame(win, cfg.skip_angles + skip0 + pe0, cfg)

    return jax.lax.map(one, jnp.arange(nz), batch_size=min(nz, cfg.frame_block))


def incremental_applicable(cfg: ReconConfig, work: int, slide: int, nz: int) -> bool:
    """True when the telescoping sliding-window path is mathematically valid:
    plain adjoint recon (no CGNR), golden-angle scheme (the spoke angle is a
    function of the *global* profile index, `src/tron.cu:509` — linear-angle
    windows re-index angles per frame and do not telescope), and genuinely
    overlapping windows."""
    from tron_jax.config import AngleScheme

    return (
        cfg.niter == 0
        and cfg.scheme_for("adjoint") == AngleScheme.GOLDEN
        and 0 < slide < work
        and nz > 1
    )


@functools.partial(jax.jit, static_argnames=("cfg", "npe1work", "prof_slide", "nz"))
def recon_frames_incremental(
    data: jnp.ndarray,
    cfg: ReconConfig,
    npe1work: int,
    prof_slide: int,
    nz: int,
    skip0: jnp.ndarray | int = 0,
) -> jnp.ndarray:
    """Telescoping sliding-window recon. Same contract as recon_frames.

    Gridding is linear over spokes, and under the golden-angle scheme a
    spoke's angle (hence its entire gridded footprint) depends only on its
    global profile index — so consecutive frames share work - slide identical
    spoke contributions.  Instead of regridding all ``work`` spokes per frame
    (the reference's per-frame loop, `src/tron.cu:732-757`), this path grids
    the first window once and then advances by one *signed* gridding call of
    2*slide spokes per frame (leaving spokes weighted -1, entering +1):

        kgrid[z+1] = kgrid[z] - grid(spokes[z*s : z*s+s])
                              + grid(spokes[z*s+w : z*s+w+s])

    The telescoping cancellation is near-exact even with reduced-precision
    products: a spoke's operand rounding is identical in its entering and
    leaving calls (same angle, same samples), so only fp32
    accumulation-order noise survives.  chip_smoke.py holds the 956-frame
    whole-body series within 1e-4 worst-frame NRMSE of the direct path.

    Frames run in blocks of cfg.inc_block per lax.scan step (one batched
    delta gridding + an in-block cumulative sum + a batched epilogue); with
    the default block of 1 XLA accumulates the carried grid in place
    instead of materializing bs delta grids and a cumsum.
    """
    from tron_jax.kernels.kb import kb_beta
    from tron_jax.nufft import _adjoint_epilogue, grid_backend, sdc_weights
    from tron_jax.trajectory import spoke_angles as _angles

    nro = data.shape[-1]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    beta = kb_beta(cfg.kernwidth, cfg.gridos, cfg.beatty)
    scheme = cfg.scheme_for("adjoint")
    # SDC weights use the *frame* spoke count (reference parity,
    # src/tron.cu:405-416) and are applied once, upstream of every call
    src = data * sdc_weights(cfg, nro, npe1work).astype(data.dtype)
    backend = grid_backend(cfg)

    def gridw(win, angles):
        return backend(win, angles, nxos, cfg.kernwidth, beta)

    def window(pe0, m):
        return jax.lax.dynamic_slice_in_dim(src, pe0, m, axis=-2)

    def angles_of(pe0, m):
        return _angles(m, scheme, cfg.skip_angles + skip0 + pe0)

    def frame_image(kg):
        return _combine(_adjoint_epilogue(kg, n, cfg, beta), cfg)

    return incremental_scan(
        window, angles_of, gridw, frame_image,
        npe1work, prof_slide, nz, block=cfg.inc_block,
    )


def incremental_scan(
    window, angles_of, gridw, frame_image,
    work: int, slide: int, nframes: int,
    z0: jnp.ndarray | int = 0, block: int = 1,
) -> jnp.ndarray:
    """The telescoping scan core, shared by the single-device and the
    frame-sharded schedulers.  Produces frame_image outputs for frames
    z0 .. z0 + nframes - 1 (z0 may be a traced per-shard offset).

    ``window(pe0, m)`` slices m spokes (axis -2) at global spoke offset pe0;
    ``angles_of(pe0, m)`` their angles; ``gridw(win, angles)`` grids them
    (with the backend's own 1/(nxos*m) scale — deltas re-scale to the
    frame's 1/work here); ``frame_image(kgrid)`` runs epilogue + combine.

    Frames past the acquisition (a sharded pad tail) read clamped windows —
    garbage that only reaches outputs the caller discards.
    """
    kg0 = gridw(window(z0 * slide, work), angles_of(z0 * slide, work))
    img0 = frame_image(kg0)
    if nframes == 1:
        return img0[None]

    # every gridding call scales by 1/(nxos * npe_of_call); deltas must carry
    # the frame scale 1/(nxos * work) instead
    corr = (2.0 * slide) / work

    def delta(z):
        pe0 = (z - 1) * slide
        leave = window(pe0, slide)
        enter = window(pe0 + work, slide)
        win = jnp.concatenate([-leave, enter], axis=-2)
        ang = jnp.concatenate([angles_of(pe0, slide), angles_of(pe0 + work, slide)])
        return gridw(win, ang) * corr

    nrest = nframes - 1
    bs = min(max(1, block), nrest)
    nblk = -(-nrest // bs)

    def step(kg, b):
        zs = z0 + 1 + b * bs + jnp.arange(bs)
        deltas = jax.vmap(delta)(zs)           # (bs, C, nxos, nxos)
        cums = kg[None] + jnp.cumsum(deltas, axis=0)
        return cums[-1], jax.vmap(frame_image)(cums)

    _, imgs = jax.lax.scan(step, kg0, jnp.arange(nblk))
    imgs = imgs.reshape((nblk * bs,) + imgs.shape[2:])[:nrest]
    return jnp.concatenate([img0[None], imgs], axis=0)


def recon_radial2d(
    indata: np.ndarray, cfg: ReconConfig, half_readback: bool = False
) -> np.ndarray:
    """Host-level recon mimicking the reference driver contract.

    adjoint: indata (nc, nt, nro, npe1) [+ optional trailing npe2 axis]
    -> images (nt, nx, ny, nz) ... returned as (nz, nt, n, n) C-ordered;
    the CLI relabels to .ra dims (1, nt, nx, ny, nz).

    forward: indata (nc, nt, nx, ny, nz) images -> (nc, nt, nro, npe1, nz).

    ``half_readback``: cast images to float16 ON DEVICE before the D2H
    transfer (halving readback bytes) and recombine to complex64 on host —
    value-identical to a host-side ``--half`` conversion (the f16->f32->f16
    roundtrip is exact), so the CLI enables it whenever ``--half`` output
    is requested anyway.  Adjoint paths only.
    """
    if cfg.koosh:
        return _recon_stack_of_stars(indata, cfg, half_readback)
    if cfg.adjoint:
        nc, nt, nro, npe1 = indata.shape[:4]
        work, slide, nz = cfg.frame_geometry(nro, npe1)
        # ops layout: channels = nt*nc, spokes, readout
        dnp = np.ascontiguousarray(
            np.transpose(indata.reshape(nc, nt, nro, npe1, -1)[..., 0], (1, 0, 3, 2))
        ).reshape(nt * nc, npe1, nro)
        d = jnp.asarray(dnp)
        if 0 < cfg.coil_compress < nc:
            from tron_jax.ops.coil import coil_compress

            dc = d.reshape(nt, nc, npe1, nro)
            d = jax.jit(jax.vmap(lambda x: coil_compress(x, cfg.coil_compress)))(dc)
            nc = cfg.coil_compress
            d = d.reshape(nt * nc, npe1, nro)
        frames_fn = (
            recon_frames_incremental
            if cfg.incremental and incremental_applicable(cfg, work, slide, nz)
            else recon_frames
        )
        if nt > 1:
            # combine coils per repetition
            d = d.reshape(nt, nc, npe1, nro)
            out = jax.lax.map(lambda dd: frames_fn(dd, cfg, work, slide, nz), d)
            return _fetch_host(jnp.moveaxis(out, 0, 1), half_readback)
        out = frames_fn(d, cfg, work, slide, nz)  # (nz, n, n)
        return _fetch_host(out, half_readback)[:, None]
    else:
        nc, nt, nx, ny, nz = indata.shape[:5]
        nro = int(cfg.gridos * nx)
        npe1 = int(cfg.data_undersamp * nro)
        # (nc, nt, nx, ny, nz) -> (nz, nc*nt, ny, nx) host-side
        imgs_np = np.ascontiguousarray(
            np.transpose(np.asarray(indata), (4, 0, 1, 3, 2))
        ).reshape(nz, nc * nt, ny, nx)
        imgs = jnp.asarray(imgs_np)

        scheme = cfg.scheme_for("forward")
        fb = cfg.frame_block

        @jax.jit
        def fwd(stack):
            def one(zimg):
                angles = spoke_angles(npe1, scheme, cfg.skip_angles)
                return nufft_forward(zimg, angles, cfg, nro=nro)

            return jax.lax.map(one, stack, batch_size=min(nz, fb))

        out = np.asarray(fwd(imgs))  # (nz, nc*nt, npe1, nro)
        return out.reshape(nz, nc, nt, npe1, nro)


def _stream_coil_basis(path, npe1: int, ncomp: int, chunk: int = 4096):
    """Global SVD coil-compression basis from a windowed disk pass.

    Accumulates the whole-acquisition coil Gram G_t = X_t X_t^H per
    repetition in chunks of profiles (the file never fully enters RAM),
    then takes the top-``ncomp`` eigenvectors — the same
    Buehrer/Huang SCC basis ops.coil.coil_compress computes in-memory
    (there from the stacked data directly; identical subspace).  Returns
    (nt, nc, ncomp) complex64.
    """
    from tron_jax.io.native import ra_read_profiles

    G = None
    for pe0 in range(0, npe1, chunk):
        blk = ra_read_profiles(path, pe0, min(chunk, npe1 - pe0))
        nc, nt = blk.shape[:2]
        X = blk.transpose(1, 0, 2, 3).reshape(nt, nc, -1)
        # per-chunk Gram in c64 BLAS, accumulated in c128
        g = np.einsum("tcm,tdm->tcd", X, X.conj()).astype(np.complex128)
        G = g if G is None else G + g
    basis = np.empty((G.shape[0], G.shape[1], ncomp), np.complex64)
    for t in range(G.shape[0]):
        _, vecs = np.linalg.eigh(G[t])          # ascending eigenvalues
        basis[t] = vecs[:, ::-1][:, :ncomp]     # top-ncomp components
    return basis


def recon_radial2d_streaming(
    path,
    cfg: ReconConfig,
    batch_frames: int = 64,
    mesh=None,
    writer=None,
    half: bool = False,
) -> np.ndarray | None:
    """Sliding-window adjoint recon streamed from disk.

    ``mesh``: an optional ('frame', 'coil') device mesh — each disk block's
    frame batch then runs through the sharded scheduler
    (parallel.recon_frames_sharded) instead of the single-device lax.map,
    composing the two scale axes: arbitrarily long acquisitions from disk x
    multi-chip frame data-parallelism.

    The whole pipeline is a 3-stage overlap, the analog of the reference's
    NSTREAMS=2 stream pool with pinned-memory async copies
    (`src/tron.cu:734-781`):

      * a LOADER thread reads the next block's profile window from disk
        (io/native.ra_read_profiles — the acquisition never fully enters
        host RAM) and uploads it, overlapping the current block's compute
        (the async-H2D half);
      * the main thread dispatches each block's recon (JAX dispatch is
        async, so the device runs ahead);
      * a READER thread pulls the previous block's finished images back to
        the host while the device computes the current block (the async-D2H
        half — previously serial, the round-3 wall-time whale).

    ``writer(z0, block)``: optional sink called in block order with the
    host images of frames [z0, z0+bf) — the CLI lands each block into its
    region of the output .ra (io.ra.RaWriter) instead of accumulating nz
    frames in RAM.  Tail blocks realign to nz-bf, so a later call may
    legally rewrite earlier frames.  When provided, returns None.

    ``half=True`` casts the images to float16 ON DEVICE before readback,
    halving D2H bytes.  Blocks are
    then delivered / returned as float16 re/im planes stacked on a LEADING
    axis of 2 — the raread.m pair convention the ``--half`` output format
    stores anyway.

    Block shapes: (bf, nt, n, n) for combined output, (bf, nt, nc, n, n)
    for coil_combine='none'; with half, (2, bf, nt, [nc,] n, n) float16.
    Inputs may be complex, plain float, or float16 re/im-pair files (the
    stride-aware windowed reader handles all three); repetitions (nt > 1)
    loop host-side per block, reusing one compiled program.  Coil
    compression (cfg.coil_compress) runs a disk-only first pass for the
    global virtual-coil basis (_stream_coil_basis), then projects each
    block before upload — shrinking H2D bytes by ncomp/nc.

    Without ``writer``, returns all frames stacked: (nz, nt, [nc,] n, n)
    complex64, or (2, nz, nt, [nc,] n, n) float16 when half.
    """
    from tron_jax.io import ra_query
    from tron_jax.io.native import ra_read_profiles, radial_dims
    from tron_jax.utils.xfer import to_host_planes

    hdr = ra_query(path)
    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    if npe2 != 1:
        raise ValueError("streaming recon supports npe2 == 1 (use -3 for stacks)")
    if not cfg.adjoint or cfg.koosh:
        raise ValueError("streaming recon is adjoint (-a), non-koosh only")
    basis = None
    if 0 < cfg.coil_compress < nc:
        # SVD compression needs a global (whole-acquisition) basis (a
        # per-block basis would change virtual coils across blocks), so a
        # cheap disk-only first pass accumulates the nc x nc coil Gram
        # chunk by chunk and fixes the basis before any block uploads.
        # Bonus: projecting each block to ncomp virtual coils BEFORE the
        # H2D upload shrinks transfer bytes by ncomp/nc.
        basis = _stream_coil_basis(path, npe1, cfg.coil_compress)
    work, slide, nz = cfg.frame_geometry(nro, npe1)

    bf = min(batch_frames, nz)
    # tail block realigned to nz - bf (same compiled shape as every block)
    z0s = [min(z0, nz - bf) for z0 in range(0, nz, bf)]

    def load(z0):
        """Disk window -> device upload for one block (loader thread)."""
        pe0 = z0 * slide
        blk = ra_read_profiles(path, pe0, work + (bf - 1) * slide)
        # (nc, nt, nro, npe) -> (nt, nc, npe, nro)
        if basis is not None:
            # per-repetition projection onto the global virtual-coil basis
            # (einsum reads the transposed view directly — no pre-copy)
            d = np.ascontiguousarray(
                np.einsum("tck,tcpr->tkpr", basis.conj(),
                          blk.transpose(1, 0, 3, 2))
            ).astype(np.complex64)
        else:
            d = np.ascontiguousarray(blk.transpose(1, 0, 3, 2))
        return jax.device_put(d), pe0

    from concurrent.futures import ThreadPoolExecutor

    if mesh is not None:
        from tron_jax.parallel import recon_frames_sharded

        def recon_block(d_t, pe0):
            return recon_frames_sharded(
                d_t, cfg, mesh, work, slide, bf, jnp.int32(pe0)
            )

    else:
        frames_fn = (
            recon_frames_incremental
            if cfg.incremental and incremental_applicable(cfg, work, slide, bf)
            else recon_frames
        )

        def recon_block(d_t, pe0):
            return frames_fn(d_t, cfg, work, slide, bf, jnp.int32(pe0))

    def fetch(dev_outs):
        """Device block -> host arrays (reader thread; one per repetition).
        half: f16 re/im planes, (2, bf, nt, ...); else complex64
        (bf, nt, ...)."""
        if half:
            planes = [to_host_planes(o, np.float16) for o in dev_outs]
            return np.stack(
                [np.stack([p[0] for p in planes], axis=1),
                 np.stack([p[1] for p in planes], axis=1)]
            )
        return np.stack([np.asarray(o) for o in dev_outs], axis=1)

    outs = None if writer is not None else [None] * nz

    def drain(z0, fut):
        blk = fut.result()
        if writer is not None:
            writer(z0, blk)
            return
        for i in range(bf):
            # frame axis is axis 0 (plain) or axis 1 (half's leading planes)
            outs[z0 + i] = blk[:, i] if half else blk[i]

    with ThreadPoolExecutor(max_workers=1) as loader, ThreadPoolExecutor(
        max_workers=1
    ) as reader:
        fut = loader.submit(load, z0s[0])
        pending = []  # [(z0, readback future)] in block order
        for bi, z0 in enumerate(z0s):
            d, pe0 = fut.result()
            if bi + 1 < len(z0s):
                fut = loader.submit(load, z0s[bi + 1])
            # dispatch is async: the device starts this block while the
            # reader thread still streams the previous block's images out
            dev_outs = [recon_block(d[t], pe0) for t in range(nt)]
            pending.append((z0, reader.submit(fetch, dev_outs)))
            while len(pending) > 1:
                drain(*pending.pop(0))
        while pending:
            drain(*pending.pop(0))
    if writer is not None:
        return None
    stacked = np.stack(outs, axis=1 if half else 0)
    return stacked


def _recon_stack_of_stars(
    indata: np.ndarray, cfg: ReconConfig, half_readback: bool = False
) -> np.ndarray:
    """3D stack-of-stars (`-3`): 2D radial in-plane x Cartesian phase
    encoding along kz.

    The reference's -3 flag only relabels dimensions (src/tron.cu:922-927 —
    no 3D kernel exists); here it gets real semantics: the kz axis (npe2) is
    a centered Cartesian FFT axis, decoupled from the in-plane NUFFT, so the
    adjoint is ifft_z then per-slice 2D gridding recon and the forward is
    per-slice degrid then fft_z.  ONE host->device transfer per
    direction, the kz FFT on device, and slices batched under the same jit
    through the frame machinery (they are embarrassingly parallel, like
    frames) — no per-slice host round trips.
    """
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    if cfg.adjoint:
        nc, nt, nro, npe1, npe2 = indata.shape[:5]
        work, slide, nzi = cfg2.frame_geometry(nro, npe1)
        # one upload; centered kz IFFT
        # (unnormalized, cuFFT-style) on device, then slice blocks batch
        # through the frame machinery with PIPELINED readback — they are
        # embarrassingly parallel, like frames
        dnp = np.ascontiguousarray(
            np.transpose(np.asarray(indata), (1, 0, 3, 2, 4))
        ).reshape(nt * nc, npe1, nro, npe2)
        d = jnp.asarray(dnp)
        return _koosh_adjoint_pipelined(
            d, cfg2, work, slide, nzi, nt, nc, half=half_readback
        )
    else:
        nc, nt, nx, ny, nz = indata.shape[:5]
        nro = int(cfg.gridos * nx)
        npe1 = int(cfg.data_undersamp * nro)
        imgs_np = np.ascontiguousarray(
            np.transpose(np.asarray(indata), (4, 0, 1, 3, 2))
        ).reshape(nz, nc * nt, ny, nx)
        imgs = jnp.asarray(imgs_np)
        out = np.asarray(_koosh_forward_device(imgs, cfg2, npe1, nro))
        return out.reshape(nz, nc, nt, npe1, nro)


@functools.partial(jax.jit, static_argnames=("npe2",))
def _koosh_kz_ifft(d, npe2):
    """Centered kz IFFT (unnormalized, cuFFT-style) of the stack-of-stars
    phase axis; d: (nt*nc, npe1, nro, npe2) -> (npe2, nt*nc, npe1, nro),
    kept on device for the slice-block pipeline."""
    sl = jnp.fft.fftshift(
        jnp.fft.ifft(jnp.fft.ifftshift(d, axes=-1), axis=-1), axes=-1
    ) * npe2
    return jnp.moveaxis(sl, -1, 0)


@functools.partial(
    jax.jit,
    static_argnames=("cfg2", "work", "slide", "nzi", "nt", "nc", "bs", "nb"),
)
def _koosh_slice_block(sl, b0, cfg2, work, slide, nzi, nt, nc, bs, nb, skip0=0):
    """One pipelined block of ``nb`` kz slices starting at traced offset
    ``b0``: (npe2, nt*nc, npe1, nro) -> (nb, nzi, nt, [nc,] n, n).  All
    blocks share one compiled program (b0 is traced; the tail realigns).
    ``skip0`` is the traced global profile offset of sl[..., 0, :] — the
    streamed -3 driver feeds overlapping npe1 windows through this same
    program by varying it (recon_frames contract)."""
    blk = jax.lax.dynamic_slice_in_dim(sl, b0, nb, axis=0)
    blk = blk.reshape(nb, nt, nc, blk.shape[-2], blk.shape[-1])

    def per_slice(sd):                     # (nt, nc, npe1, nro)
        return jax.lax.map(
            lambda dd: recon_frames(dd, cfg2, work, slide, nzi, skip0), sd
        )                                  # (nt, nzi, [nc,] n, n)

    out = jax.lax.map(per_slice, blk, batch_size=min(nb, bs))
    return jnp.moveaxis(out, 2, 1)         # (nb, nzi, nt, [nc,] n, n)


def _koosh_adjoint_pipelined(
    d, cfg2, work, slide, nzi, nt, nc, half: bool = False
) -> np.ndarray:
    """Host driver of the -3 adjoint: kz IFFT on device, then kz-slice
    blocks reconstructed and read back in a 2-stage pipeline — a reader
    thread streams block b's images to the host while the device computes
    block b+1 (the per-frame async D2H overlap of the reference driver,
    `src/tron.cu:767-781`; previously one serial whole-stack transfer).
    d: (nt*nc, npe1, nro, npe2) -> (npe2*nzi, nt, [nc,] n, n) host array.
    ``half``: f16 readback (see _fetch_host; exact under a --half store)."""
    from concurrent.futures import ThreadPoolExecutor

    npe2 = int(d.shape[-1])
    nro = int(d.shape[-2])
    sl = _koosh_kz_ifft(d, npe2)
    bs = cfg2.frame_block
    # block = a few readbacks' worth of slices: big enough to amortize the
    # per-dispatch round trip, small enough that >=2 blocks overlap
    nb = min(npe2, max(bs, 8))
    b0s = [min(b0, npe2 - nb) for b0 in range(0, npe2, nb)]

    out = None

    def drain(b0, fut):
        nonlocal out
        blk = fut.result()                 # (nb, nzi, nt, [nc,] n, n)
        blk = blk.reshape((nb * nzi,) + blk.shape[2:])
        if out is None:
            out = np.empty((npe2 * nzi,) + blk.shape[1:], blk.dtype)
        out[b0 * nzi : b0 * nzi + nb * nzi] = blk

    with ThreadPoolExecutor(max_workers=1) as reader:
        pending = []
        for b0 in b0s:
            dev = _koosh_slice_block(
                sl, jnp.int32(b0), cfg2, work, slide, nzi, nt, nc, bs, nb
            )
            pending.append((b0, reader.submit(_fetch_host, dev, half)))
            while len(pending) > 1:
                drain(*pending.pop(0))
        while pending:
            drain(*pending.pop(0))
    return out


def recon_koosh_streaming(
    path,
    cfg: ReconConfig,
    batch_frames: int = 8,
    writer=None,
    half: bool = False,
) -> np.ndarray | None:
    """Streamed 3-D stack-of-stars (`-3 --stream`) adjoint.

    The kz IFFT mixes every npe2 encoding of a sample, so `-3` cannot
    stream over kz — but it is POINTWISE over profiles, so streaming over
    npe1 is exact: each disk block is the profile window covering
    ``batch_frames`` in-plane frames at ALL npe2 encodings
    (io.native.ra_read_profiles_stack — one contiguous region read per kz
    encoding), kz-IFFT'd on device per block, then slice blocks run the
    SAME compiled program as the in-memory path (_koosh_slice_block) with
    the block's global profile offset threaded as skip0.

    Memory: host holds ~2 profile windows of nc*nt*nro*npe2 complex
    samples instead of the whole acquisition — for a reference-scale
    stack (6 x 512 x 20271 x 32 = 15.9 GB) a bf=8 window is ~630 MB.

    ``writer(z0, blk)``: called with CONTIGUOUS output-frame runs — frames
    are slice-major ((b, z) -> b*nzi + z, matching the in-memory output
    and the .ra frame axis), so each (slice, frame-window) pair lands as
    one region; tail blocks realign on both axes (legal rewrites).
    Without ``writer``, returns (npe2*nzi, nt, [nc,] n, n) complex64 —
    bit-comparable to the in-memory `-3` output.

    ``half``: f16 device-side readback (halved D2H bytes; exact under a
    later --half store) — blocks always reach the writer as complex64.
    """
    from concurrent.futures import ThreadPoolExecutor

    from tron_jax.io import ra_query
    from tron_jax.io.native import ra_read_profiles_stack, radial_dims

    hdr = ra_query(path)
    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    if not cfg.adjoint or not cfg.koosh:
        raise ValueError("recon_koosh_streaming is the -3 adjoint driver")
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    work, slide, nzi = cfg2.frame_geometry(nro, npe1)

    bf = min(batch_frames, nzi)
    z0s = [min(z0, nzi - bf) for z0 in range(0, nzi, bf)]
    bs = cfg2.frame_block
    nb = min(npe2, max(bs, 8))
    b0s = [min(b0, npe2 - nb) for b0 in range(0, npe2, nb)]

    def load(z0):
        pe0 = z0 * slide
        blk = ra_read_profiles_stack(path, pe0, work + (bf - 1) * slide)
        # (nc, nt, nro, npe, npe2) -> (nt*nc, npe, nro, npe2)
        d = np.ascontiguousarray(blk.transpose(1, 0, 3, 2, 4)).reshape(
            nt * nc, -1, nro, npe2
        )
        return jax.device_put(d), pe0

    full = None

    def drain(z0, b0, fut):
        nonlocal full
        blk = fut.result()                 # (nb, bf, nt, [nc,] n, n) c64
        if writer is not None:
            for i in range(nb):
                writer((b0 + i) * nzi + z0, blk[i])
            return
        if full is None:
            full = np.empty((npe2 * nzi,) + blk.shape[2:], blk.dtype)
        for i in range(nb):
            full[(b0 + i) * nzi + z0 : (b0 + i) * nzi + z0 + bf] = blk[i]

    with ThreadPoolExecutor(max_workers=1) as loader, ThreadPoolExecutor(
        max_workers=1
    ) as reader:
        fut = loader.submit(load, z0s[0])
        pending = []
        for zi, z0 in enumerate(z0s):
            d, pe0 = fut.result()
            if zi + 1 < len(z0s):
                fut = loader.submit(load, z0s[zi + 1])
            sl = _koosh_kz_ifft(d, npe2)
            for b0 in b0s:
                dev = _koosh_slice_block(
                    sl, jnp.int32(b0), cfg2, work, slide, bf, nt, nc, bs, nb,
                    jnp.int32(pe0),
                )
                pending.append((z0, b0, reader.submit(_fetch_host, dev, half)))
                while len(pending) > 1:
                    drain(*pending.pop(0))
        while pending:
            drain(*pending.pop(0))
    return full if writer is None else None


@functools.partial(jax.jit, static_argnames=("cfg2", "npe1", "nro"))
def _koosh_forward_device(stack, cfg2, npe1, nro):
    """Device side of the -3 forward: slice-batched degrids + centered
    forward kz FFT (unnormalized). stack: (nz, nc*nt, ny, nx)."""
    nz = stack.shape[0]
    angles = spoke_angles(npe1, cfg2.scheme_for("forward"), cfg2.skip_angles)
    data = jax.lax.map(
        lambda zimg: nufft_forward(zimg, angles, cfg2, nro=nro),
        stack,
        batch_size=min(nz, cfg2.frame_block),
    )                                      # (nz, nc*nt, npe1, nro)
    data = jnp.moveaxis(data, 0, -1)
    kz = jnp.fft.fftshift(
        jnp.fft.fft(jnp.fft.ifftshift(data, axes=-1), axis=-1), axes=-1
    )
    return jnp.moveaxis(kz, -1, 0)         # (npe2, nc*nt, npe1, nro)
