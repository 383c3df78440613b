"""Command-line interface, flag-compatible with the reference binary so the
RUNME pipeline scripts run unchanged (`src/tron.cu:790-874`).

Usage: tron [-3aGhv] [-i n] [-k w] [-o os] [-u f] [-d slide] [-s skip]
            [-B blocks] [-T threads] [-g gpu] in.ra [out.ra]

-B/-T (CUDA launch geometry) are accepted and ignored; -g selects a JAX
device index.  Dimension inference follows src/tron.cu:904-961: adjoint
input is a 5-D .ra (nc, nt, nro, npe1, npe2) -> output (1, nt, nx, ny, nz)
with nx = nro/2; forward input is an image stack -> (nc, nt, nro, npe1, npe2).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tron_jax.config import ReconConfig
from tron_jax.io import ra_read, ra_write


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tron",
        description="Trajectory-optimized Non-uniform Fast Fourier Transform",
    )
    p.add_argument("-3", dest="koosh", action="store_true", help="3D stack-of-stars")
    p.add_argument("-a", dest="adjoint", action="store_true", help="adjoint operation")
    p.add_argument("-B", dest="blocks", type=int, default=4096, help="(ignored; CUDA compat)")
    p.add_argument("-d", dest="prof_slide", type=int, default=0, help="profiles to slide between frames")
    p.add_argument("-g", dest="device", type=int, default=0, help="device index")
    p.add_argument("-G", dest="golden_angle", action="store_true", help="golden angle radial")
    p.add_argument("-i", dest="niter", type=int, default=0, help="CGNR iterations")
    p.add_argument("-k", dest="kernwidth", type=float, default=2.0, help="gridding kernel width")
    p.add_argument("-o", dest="gridos", type=float, default=2.0, help="grid oversampling factor")
    p.add_argument("-r", dest="nro", type=int, default=0, help="(unused, like the reference)")
    p.add_argument("-s", dest="skip_angles", type=int, default=0, help="initial profiles to skip")
    p.add_argument("-T", dest="threads", type=int, default=128, help="(ignored; CUDA compat)")
    p.add_argument("-u", dest="data_undersamp", type=float, default=1.0, help="data undersampling factor")
    p.add_argument("-v", dest="verbose", action="store_true", help="verbose output")
    p.add_argument("--backend", default="auto", choices=["auto", "jnp", "pallas"],
                   help="adjoint gridder: auto = the Triton kernel on a GPU "
                   "and the plain XLA gridder on the CPU; jnp = plain XLA; "
                   "pallas = the Triton kernel (GPU only)")
    p.add_argument(
        "--scheme",
        default=None,
        choices=["linear_half", "linear_full"],
        help="linear-angle convention override; the reference uses linear_half "
        "for degrid and linear_full for grid (src/tron.cu:509 vs :555), so a "
        "self-consistent degrid->grid roundtrip needs an explicit scheme",
    )
    p.add_argument("--sdc", default="ramlak", choices=["ramlak", "ideal"],
                   help="density compensation: reference Ram-Lak or exact polar cells")
    p.add_argument("--combine", default="sos", choices=["sos", "walsh", "none"],
                   help="coil combination (adjoint only)")
    p.add_argument("--half", action="store_true",
                   help="write float16 output (.ra eltype float/2, the fp16 "
                   "path of the reference's float16.cu)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the recon into DIR")
    p.add_argument("--precision", default="fast", choices=["fast", "accurate"],
                   help="the GPU gridder's products: fast = TF32 tensor "
                   "cores with fp32 accumulation, accurate = fp32")
    p.add_argument("--compress", type=int, default=0, metavar="N",
                   help="SVD-compress to N virtual coils before gridding")
    p.add_argument("--toeplitz", action="store_true",
                   help="with -i: apply the CGNR normal operator as a "
                   "Toeplitz-embedded FFT convolution (one precomputed PSF "
                   "kernel per frame; each iteration costs two 2n-FFT pairs "
                   "instead of a degrid+grid)")
    p.add_argument("--incremental", action="store_true",
                   help="telescoping sliding-window gridding: advance each "
                   "frame's k-space grid by a signed 2*slide-spoke delta "
                   "instead of regridding the whole window (golden-angle "
                   "adjoint with overlapping windows only; other cases fall "
                   "back to the direct path)")
    p.add_argument("--shard", action="store_true",
                   help="shard frames across all local devices (adjoint 2D "
                   "recon; single-process mesh via shard_map)")
    p.add_argument("--shard-spokes", action="store_true",
                   help="shard each frame's SPOKES across all local devices "
                   "(adjoint 2D recon; latency-parallel single-frame mode — "
                   "partial grids psum over a 'spoke' mesh axis)")
    p.add_argument("--stream", action="store_true",
                   help="stream profile windows from disk instead of loading "
                   "the whole acquisition (adjoint recon, any nt, "
                   "complex/float/fp16-pair inputs; the native windowed .ra "
                   "reader feeds one compiled frame-batch program block by "
                   "block, with pipelined readback written straight to the "
                   "output file).  With -3, streams npe1 profile windows at "
                   "all kz encodings (kz itself cannot stream: the kz IFFT "
                   "mixes every npe2 encoding of a sample)")
    p.add_argument("infile")
    p.add_argument("outfile", nargs="?", default="img_tron.ra")
    return p


def _recon_sharded_cli(indata, cfg):
    """Frame-sharded adjoint recon over all local devices.

    Repetitions (nt > 1) loop host-side, reusing the compiled sharded step;
    all coil-combine modes are supported (the 'none' output keeps the coil
    axis, mirroring the local path's layout)."""
    import jax
    import jax.numpy as jnp

    from tron_jax.parallel import make_mesh, recon_frames_sharded

    nc, nt, nro, npe1 = indata.shape[:4]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    mesh = make_mesh(n_frame=len(jax.devices()), n_coil=1)
    outs = []
    for t in range(nt):
        d = np.ascontiguousarray(
            np.transpose(indata.reshape(nc, nt, nro, npe1, -1)[..., 0][:, t], (0, 2, 1))
        )
        out = recon_frames_sharded(jnp.asarray(d), cfg, mesh, work, slide, nz)
        outs.append(np.asarray(out))
    return np.stack(outs, axis=1)  # (nz, nt, [nc,] n, n)


def _recon_spoke_sharded_cli(indata, cfg):
    """Spoke-sharded adjoint recon: every frame's profiles split across all
    local devices (parallel/spoke.py) — the latency-parallel mode, useful
    when frames must come out one at a time (e.g. the latest window of a
    live acquisition) rather than in bulk.

    Frames and repetitions loop host-side; windows are sliced on the host so
    nothing runs eagerly on the device between the jitted sharded steps."""
    import jax.numpy as jnp

    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded

    nc, nt, nro, npe1 = indata.shape[:4]
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    mesh = make_spoke_mesh()
    outs = []
    for t in range(nt):
        d = np.ascontiguousarray(
            np.transpose(indata.reshape(nc, nt, nro, npe1, -1)[..., 0][:, t], (0, 2, 1))
        )
        frames = [
            np.asarray(
                recon_window_spoke_sharded(
                    jnp.asarray(d[:, z * slide : z * slide + work, :]),
                    cfg,
                    mesh,
                    skip=z * slide,
                )
            )
            for z in range(nz)
        ]
        outs.append(np.stack(frames, axis=0))  # (nz, [nc,] n, n)
    return np.stack(outs, axis=1)  # (nz, nt, [nc,] n, n)


def _block_to_disk_order(blk, half: bool):
    """Reorder one streamed block of frame images into on-disk .ra element
    order (dims[0] fastest: [pair-of-2,] coil, t, x, y, frame — see the
    output transposes at the bottom of main(), whose bytes this must match
    exactly).

    blk: (bf, nt, [nc,] ny, nx) complex64, or (2, bf, nt, [nc,] ny, nx)
    float16 re/im planes when ``half``.
    """
    if half:
        if blk.ndim == 5:        # (2, bf, nt, ny, nx) -> (bf, y, x, t, 2)
            return np.ascontiguousarray(blk.transpose(1, 3, 4, 2, 0))
        # (2, bf, nt, nc, ny, nx) -> (bf, y, x, t, c, 2)
        return np.ascontiguousarray(blk.transpose(1, 4, 5, 2, 3, 0))
    if blk.ndim == 4:            # (bf, nt, ny, nx) -> (bf, y, x, t)
        return np.ascontiguousarray(blk.transpose(0, 2, 3, 1))
    # (bf, nt, nc, ny, nx) -> (bf, y, x, t, c)
    return np.ascontiguousarray(blk.transpose(0, 3, 4, 1, 2))


def _run_streamed(args, base_dims, prep, recon_call) -> int:
    """Shared scaffolding of the two --stream drivers: open the output .ra
    for region writes, hand the recon driver a writer that lands each block
    at its frame offset in on-disk element order, translate input
    ValueErrors to a clean exit, and abort the partial file on ANY failure.

    prep(blk) -> blk runs host-side per block before the layout transpose
    (the koosh driver's --half pair cast); recon_call(writer) runs the
    actual streamed recon."""
    from tron_jax.io import RaWriter

    dims = (2, *base_dims) if args.half else base_dims
    dtype = np.float16 if args.half else np.complex64
    frame_elems = int(np.prod(dims[:-1]))

    w = RaWriter(args.outfile, dims, dtype)

    def writer(z0, blk):
        w.write_at(z0 * frame_elems, _block_to_disk_order(prep(blk), args.half))

    try:
        recon_call(writer)
    except ValueError as e:
        w.abort()
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BaseException:
        w.abort()
        raise
    w.close()
    return 0


def _stream_to_file(args, cfg, hdr, smesh) -> int:
    """--stream: recon blocks land straight into their region of the output
    .ra as the device computes the next block (writer thread + RaWriter
    region writes; the output half of the reference's per-frame async D2H
    overlap, src/tron.cu:767-781).  Peak host memory is ~2 blocks instead
    of the whole nz-frame series."""
    from tron_jax.io.native import radial_dims
    from tron_jax.recon import recon_radial2d_streaming

    nc, nt, nro, npe1, _npe2, _pair = radial_dims(hdr)
    _, _, nz = cfg.frame_geometry(nro, npe1)
    n = nro // 2
    nc_out = nc if cfg.coil_combine == "none" else 1
    if cfg.coil_combine == "none" and 0 < cfg.coil_compress < nc:
        nc_out = cfg.coil_compress  # blocks carry ncomp virtual coils

    return _run_streamed(
        args,
        (nc_out, nt, n, n, nz),
        lambda blk: blk,
        lambda writer: recon_radial2d_streaming(
            args.infile, cfg, mesh=smesh, writer=writer, half=args.half
        ),
    )


def _stream_koosh_to_file(args, cfg, hdr) -> int:
    """`-3 --stream`: npe1-blocked streamed stack-of-stars adjoint.  Each
    readback block is a contiguous run of output frames of ONE kz slice
    (slice-major frame order, identical to the in-memory -3 output), so it
    region-writes straight into the output .ra."""
    import dataclasses

    from tron_jax.io.native import radial_dims
    from tron_jax.recon import recon_koosh_streaming

    nc, nt, nro, npe1, npe2, _pair = radial_dims(hdr)
    cfg2 = dataclasses.replace(cfg, koosh=False, prof_slide=0)
    _, _, nzi = cfg2.frame_geometry(nro, npe1)
    n = nro // 2
    nz = npe2 * nzi
    # NB no coil_compress branch: the stack-of-stars drivers recon all
    # physical coils (main() prints a note when -3 --compress is given)
    nc_out = nc if cfg.coil_combine == "none" else 1

    def prep(blk):
        # blk: (bfr, nt, [nc,] ny, nx) complex64 — cast to the f16 pair
        # convention host-side when --half (value-exact: the device-side
        # f16 readback already quantized)
        if args.half:
            blk = np.stack([blk.real, blk.imag]).astype(np.float16)
        return blk

    return _run_streamed(
        args,
        (nc_out, nt, n, n, nz),
        prep,
        lambda writer: recon_koosh_streaming(
            args.infile, cfg, writer=writer, half=args.half
        ),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def vprint(*a):
        if args.verbose:
            print(*a, file=sys.stderr)

    cfg = ReconConfig(
        gridos=args.gridos,
        kernwidth=args.kernwidth,
        golden_angle=args.golden_angle,
        skip_angles=args.skip_angles,
        data_undersamp=args.data_undersamp,
        prof_slide=args.prof_slide,
        adjoint=args.adjoint,
        niter=args.niter,
        toeplitz=args.toeplitz,
        koosh=args.koosh,
        incremental=args.incremental,
        backend=args.backend,
        angle_scheme=args.scheme,
        sdc=args.sdc,
        coil_combine=args.combine,
        coil_compress=args.compress,
        precision=args.precision,
    )

    # NB: --shard honors --incremental (the frame-sharded scheduler runs a
    # per-shard telescoping scan, parallel/mesh.py), so no note for it
    if args.incremental and (
        args.shard_spokes or not cfg.golden_angle or cfg.niter > 0
    ):
        why = (
            "spoke-sharded recon" if args.shard_spokes
            else "CGNR (-i)" if cfg.niter > 0
            else "non-golden-angle scheme"
        )
        print(f"note: --incremental ignored ({why} uses the direct path)")

    # --stream composes with --shard (each disk block's frame batch runs
    # through the sharded scheduler); --shard-spokes stays in-memory.
    # -3 --stream gets its own npe1-blocked driver (kz can't stream — the
    # IFFT mixes all npe2 per sample — but profiles can, exactly).
    koosh_stream = (
        args.stream and cfg.adjoint and cfg.koosh
        and not args.shard and not args.shard_spokes
    )
    stream = (
        args.stream and cfg.adjoint and not cfg.koosh and not args.shard_spokes
    )
    if args.stream and not stream and not koosh_stream:
        why = (
            "--shard-spokes" if args.shard_spokes
            else "forward mode" if not cfg.adjoint
            else "-3 --shard"
        )
        print(f"note: --stream ignored ({why} loads the input in memory)")
    if cfg.koosh and cfg.coil_compress:
        # neither the in-memory nor the streamed stack-of-stars driver
        # compresses coils (recon._recon_stack_of_stars) — say so instead
        # of silently writing nc uncompressed coils
        print("note: --compress ignored (-3 recons all physical coils)")
    if stream or koosh_stream:
        # streaming path: only the header is read here; profile windows are
        # pulled from disk block by block inside the recon driver
        from tron_jax.io import ra_query

        vprint(f"Querying {args.infile} (streaming)")
        try:
            hdr = ra_query(args.infile)
            # same 5-D contract as the in-memory path below (which checks
            # ndim AFTER decoding the float re/im-pair convention, so a
            # 6-D pair file counts as 5-D here too)
            from tron_jax.io.native import radial_dims

            _, _, _, _, _, _pair = radial_dims(hdr)
            ndim = len(hdr.dims) - (1 if _pair else 0)
            if ndim != 5:
                print(
                    f"error: expected 5-D .ra input, got {ndim}-D",
                    file=sys.stderr,
                )
                return 1
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        indata = None
        vprint(f"indims = {tuple(int(x) for x in hdr.dims)}")
    else:
        vprint(f"Reading {args.infile}")
        try:
            indata = ra_read(args.infile)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if not (stream or koosh_stream) and not np.iscomplexobj(indata):
        # float inputs: a leading dim of 2 is the re/im-pair convention of
        # the MATLAB raread/rawrite twins (src/raread.m:25-57); anything
        # else is promoted to complex (covers the fp16 storage path)
        if indata.ndim == 6 and indata.shape[0] == 2:
            indata = (
                indata[0].astype(np.float32) + 1j * indata[1].astype(np.float32)
            ).astype(np.complex64)
        else:
            indata = indata.astype(np.complex64)
    if not (stream or koosh_stream):
        if indata.ndim != 5:
            print(
                f"error: expected 5-D .ra input, got {indata.ndim}-D",
                file=sys.stderr,
            )
            return 1
        vprint(f"indims = {indata.shape}")

    import jax

    from tron_jax.utils import enable_compilation_cache

    enable_compilation_cache()
    devices = jax.devices()
    if not 0 <= args.device < len(devices):
        print(
            f"error: -g {args.device}: no such device ({len(devices)} found)",
            file=sys.stderr,
        )
        return 1
    jax.config.update("jax_default_device", devices[args.device])

    from tron_jax.recon import recon_radial2d

    import contextlib

    prof = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )
    start = time.perf_counter()
    with prof:
        if koosh_stream:
            rc = _stream_koosh_to_file(args, cfg, hdr)
            if rc != 0:
                return rc
            out = None
        elif stream:
            smesh = None
            if args.shard:
                from tron_jax.parallel import make_mesh

                smesh = make_mesh(n_frame=len(jax.devices()), n_coil=1)
            rc = _stream_to_file(args, cfg, hdr, smesh)
            if rc != 0:
                return rc
            out = None
        elif args.shard and cfg.adjoint and not cfg.koosh:
            out = _recon_sharded_cli(indata, cfg)
        elif args.shard and cfg.adjoint and cfg.koosh:
            # -3 --shard: kz slices are embarrassingly parallel (post-IFFT),
            # sharded over the 'frame' mesh axis like frames
            from tron_jax.parallel import make_mesh, recon_stack_of_stars_sharded

            mesh3 = make_mesh(n_frame=len(jax.devices()), n_coil=1)
            out = recon_stack_of_stars_sharded(indata, cfg, mesh3)
        elif args.shard and not cfg.adjoint:
            # forward --shard: image slices degrid independently (frames =
            # DP, zero communication); -3 adds one kz-FFT all_gather
            from tron_jax.parallel import make_mesh, recon_forward_sharded

            meshf = make_mesh(n_frame=len(jax.devices()), n_coil=1)
            out = recon_forward_sharded(indata, cfg, meshf)
        elif args.shard_spokes and cfg.adjoint and not cfg.koosh:
            out = _recon_spoke_sharded_cli(indata, cfg)
        else:
            # --half output => f16 readback (halved D2H bytes, value-exact
            # under the later f16 store; adjoint only — forward .ra output
            # conversion happens host-side either way)
            out = recon_radial2d(
                indata, cfg, half_readback=args.half and cfg.adjoint
            )
    elapsed = time.perf_counter() - start
    vprint(f"Elapsed time: {elapsed:.2f} s")

    if out is None:
        # streaming path: frames were landed into the output file's regions
        # as they were read back (no full-series host array ever existed)
        vprint(f"Saved result to {args.outfile}")
        return 0

    if cfg.adjoint:
        if out.ndim == 5:
            # --combine none keeps the coil axis: (nz, nt, nc, ny, nx)
            # -> .ra dims (nc, nt, nx, ny, nz)
            arr = np.transpose(out, (2, 1, 4, 3, 0))
        else:
            # out: (nz, nt, ny, nx) -> .ra dims (1, nt, nx, ny, nz)
            arr = np.transpose(out[None], (0, 2, 4, 3, 1))
    else:
        # out: (nz, nc, nt, npe1, nro) -> .ra dims (nc, nt, nro, npe1, npe2=nz)
        arr = np.transpose(out, (1, 2, 4, 3, 0))
    if args.half:
        # fp16 storage: re/im planes on a leading dim of 2 (raread.m trick)
        arr = np.stack([arr.real, arr.imag]).astype(np.float16)
    else:
        arr = arr.astype(np.complex64)
    ra_write(arr, args.outfile)
    vprint(f"Saved result to {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
