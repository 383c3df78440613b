"""Extended CLI paths: CGNR (-i), nt > 1 repetitions, --shard, walsh."""

import numpy as np
import jax
import pytest

from tron_jax.cli import main
from tron_jax.io import ra_query, ra_read, ra_write
from tron_jax.phantom import shepp_logan


def _phantom_data(tmp_path, n=16, scheme=["--scheme", "linear_half"]):
    img = shepp_logan(n)
    src = tmp_path / "sl.ra"
    ra_write(img.T[None, None, :, :, None].astype(np.complex64), src)
    data = tmp_path / "d.ra"
    assert main([str(src), str(data)]) == 0
    return src, data, img


def test_cgnr_cli(tmp_path):
    src, data, img = _phantom_data(tmp_path)
    out = tmp_path / "cg.ra"
    assert main(["-a", "-i", "3", "--scheme", "linear_half", str(data), str(out)]) == 0
    rec = np.abs(ra_read(out)[0, 0, :, :, 0])
    assert np.isfinite(rec).all() and rec.max() > 0
    # CGNR should correlate at least as well as the plain adjoint
    adj = tmp_path / "adj.ra"
    assert main(["-a", "--scheme", "linear_half", str(data), str(adj)]) == 0
    ra_ = np.abs(ra_read(adj)[0, 0, :, :, 0])
    ref = np.abs(shepp_logan(16).T)

    def corr(m):
        a = m.ravel() - m.mean()
        b = ref.ravel() - ref.mean()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    assert corr(rec) > corr(ra_) - 0.05


def test_nt_gt_1(tmp_path, rng):
    nc, nt, nro, npe1 = 2, 3, 32, 16
    d = (rng.standard_normal((nc, nt, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, nt, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    out = tmp_path / "o.ra"
    assert main(["-a", "-G", str(p), str(out)]) == 0
    h = ra_query(out)
    assert h.dims == (1, nt, 16, 16, 1)
    arr = ra_read(out)
    assert np.isfinite(arr).all()
    # repetitions are independent recons of different data -> must differ
    assert not np.allclose(arr[0, 0], arr[0, 1])


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_shard_matches_unsharded(tmp_path, rng):
    nc, nro, npe1 = 2, 32, 48
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "8", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--shard"]) == 0
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_walsh_cli(tmp_path, rng):
    nc, nro, npe1 = 4, 32, 32
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    out = tmp_path / "w.ra"
    assert main(["-a", "-G", "--combine", "walsh", str(p), str(out)]) == 0
    arr = ra_read(out)
    assert np.isfinite(arr).all()
    # walsh keeps phase information (nonzero imaginary part), unlike SoS
    assert np.abs(arr.imag).max() > 0


def test_compress_cli(tmp_path, rng):
    """--compress N: recon runs on N virtual coils; for data truly spanning
    a low-rank coil subspace the image is unchanged."""
    nc, nro, npe1 = 6, 32, 32
    base = (rng.standard_normal((2, 1, nro, npe1, 1)) +
            1j * rng.standard_normal((2, 1, nro, npe1, 1))).astype(np.complex64)
    mix = (rng.standard_normal((nc, 2)) + 1j * rng.standard_normal((nc, 2))).astype(np.complex64)
    d = np.einsum("ck,ktrpz->ctrpz", mix, base)
    p = tmp_path / "d.ra"
    ra_write(d.astype(np.complex64), p)
    full, comp = tmp_path / "f.ra", tmp_path / "c.ra"
    assert main(["-a", "-G", str(p), str(full)]) == 0
    assert main(["-a", "-G", "--compress", "2", str(p), str(comp)]) == 0
    a, b = np.abs(ra_read(full)), np.abs(ra_read(comp))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4 * float(a.max()))


def test_stream_matches_in_memory(tmp_path, rng):
    """--stream (windowed native reads, block-batched frames) must equal the
    in-memory recon bit-for-bit-ish across multiple blocks incl. the
    realigned tail block."""
    nc, nro, npe1 = 2, 32, 200
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)


def test_streaming_driver_small_blocks(tmp_path, rng):
    """Force several blocks (batch_frames < nz) through the streaming
    driver directly and compare with recon_radial2d."""
    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_radial2d, recon_radial2d_streaming

    nc, nro, npe1 = 2, 32, 120
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4,
                      adjoint=True)
    got = recon_radial2d_streaming(p, cfg, batch_frames=7)
    want = recon_radial2d(d[..., 0], cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_nt_gt_1_shard(tmp_path, rng):
    """--shard with nt > 1 repetitions (host loop over the sharded step)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    nc, nt, nro, npe1 = 2, 2, 32, 48
    d = (rng.standard_normal((nc, nt, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, nt, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "8", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--shard"]) == 0
    assert ra_query(a).dims == ra_query(b).dims
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_shard_walsh_and_none(tmp_path, rng):
    """--shard honors --combine walsh and none (coil axis kept)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    nc, nro, npe1 = 2, 32, 48
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    for combine in ("walsh", "none"):
        a, b = tmp_path / f"a_{combine}.ra", tmp_path / f"b_{combine}.ra"
        args = ["-a", "-G", "-u", "0.5", "-d", "8", "--combine", combine, str(p)]
        assert main(args + [str(a)]) == 0
        assert main(args + [str(b), "--shard"]) == 0
        assert ra_query(a).dims == ra_query(b).dims
        np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_shard_spokes_matches_unsharded(tmp_path, rng):
    """--shard-spokes (latency-parallel: each frame's profiles split over
    the 8 virtual devices) must match the plain recon, incl. a spoke count
    that does not divide the mesh (zero-padding path)."""
    nc, nro, npe1 = 2, 32, 42
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "8", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--shard-spokes"]) == 0
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_stream_shard_matches_in_memory(tmp_path, rng):
    """--stream --shard: each disk block's frame batch runs through the
    frame-sharded scheduler (8 virtual devices), with the block's global
    profile offset traced through the sharded program.  Must match the
    plain in-memory recon across several blocks."""
    nc, nro, npe1 = 2, 32, 200
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream", "--shard"]) == 0
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_streaming_driver_sharded_blocks(tmp_path, rng):
    """Streaming driver with a mesh and batch_frames < nz: multiple disk
    blocks through the one compiled sharded program (nonzero skip0 path)."""
    import jax

    from tron_jax.config import ReconConfig
    from tron_jax.parallel import make_mesh
    from tron_jax.recon import recon_radial2d, recon_radial2d_streaming

    nc, nro, npe1 = 2, 32, 120
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4,
                      adjoint=True)
    mesh = make_mesh(n_frame=4, n_coil=2, devices=jax.devices())
    got = recon_radial2d_streaming(p, cfg, batch_frames=7, mesh=mesh)
    want = recon_radial2d(d[..., 0], cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_stream_incremental_matches_in_memory(tmp_path, rng):
    """--stream --incremental: per-block telescoping (each disk block grids
    its first window once, then advances by signed spoke deltas with the
    block's skip0 offset) must match the plain in-memory direct recon."""
    nc, nro, npe1 = 2, 32, 200
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream", "--incremental"]) == 0
    ra, rb = ra_read(a), ra_read(b)
    err = np.linalg.norm(rb - ra) / np.linalg.norm(ra)
    assert err < 1e-5, err


def test_stream_half_output_matches_in_memory(tmp_path, rng):
    """--stream --half: f16 readback planes landed by region writes must
    produce the same file as the in-memory --half path (same ties-to-even
    f32->f16 conversion, device-side vs host-side)."""
    nc, nro, npe1 = 2, 32, 120
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--half", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims and ha.dims[0] == 2  # re/im-pair convention
    assert ha.dtype == np.float16
    np.testing.assert_array_equal(ra_read(a), ra_read(b))


def test_stream_combine_none_matches_in_memory(tmp_path, rng):
    """--stream --combine none: the coil axis survives the region writes."""
    nc, nro, npe1 = 3, 32, 72
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--combine", "none", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    assert ra_query(a).dims == ra_query(b).dims == (nc, 1, 16, 16, 15)
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)


def test_stream_nt_gt_1_matches_in_memory(tmp_path, rng):
    """--stream with nt > 1 repetitions (per-block host loop over one
    compiled program; the reference's per-frame loop handles any nt,
    src/tron.cu:738-748)."""
    nc, nt, nro, npe1 = 2, 3, 32, 72
    d = (rng.standard_normal((nc, nt, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, nt, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    assert ra_query(a).dims == ra_query(b).dims == (1, nt, 16, 16, 15)
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)


def test_stream_fp16_pair_input(tmp_path, rng):
    """--stream over a float16 re/im-pair input file (the --half output
    convention): the stride-aware windowed reader must reconstruct it the
    same as the in-memory path reading the same file."""
    nc, nro, npe1 = 2, 32, 72
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    pair = np.stack([d.real, d.imag]).astype(np.float16)  # (2,nc,1,nro,npe1,1)
    p = tmp_path / "d16.ra"
    ra_write(pair, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    assert ra_query(a).dims == ra_query(b).dims
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_forward_shard_matches_unsharded(tmp_path, rng):
    """--shard on the forward (degrid) path: frame-DP over image slices."""
    nc, n, nz = 2, 16, 5
    d = (rng.standard_normal((nc, 1, n, n, nz)) +
         1j * rng.standard_normal((nc, 1, n, n, nz))).astype(np.complex64)
    p = tmp_path / "img.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-G", "-u", "0.5", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--shard"]) == 0
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_forward_shard_koosh(tmp_path, rng):
    """-3 --shard forward: sharded slice degrids + the kz-FFT gather."""
    nc, n, nz = 2, 16, 6
    d = (rng.standard_normal((nc, 1, n, n, nz)) +
         1j * rng.standard_normal((nc, 1, n, n, nz))).astype(np.complex64)
    p = tmp_path / "img.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-3", "-G", "-u", "0.5", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--shard"]) == 0
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=2e-5)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs multiple devices")
def test_stream_shard_half(tmp_path, rng):
    """--stream --shard --half: the sharded block scheduler's outputs go
    through the same on-device f16 cast + region writes."""
    nc, nro, npe1 = 2, 32, 120
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--half", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream", "--shard"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims and ha.dtype == hb.dtype == np.float16
    np.testing.assert_array_equal(ra_read(a), ra_read(b))


def test_half_readback_exact(rng):
    """f16 device-side readback (recon_radial2d half_readback) must be
    value-identical to host-side --half conversion of the f32 images —
    the f16 -> f32 -> f16 roundtrip is exact."""
    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_radial2d

    nc, nro, npe1 = 2, 32, 48
    d = (rng.standard_normal((nc, 1, nro, npe1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1))).astype(np.complex64)
    cfg = ReconConfig(golden_angle=True, adjoint=True, data_undersamp=0.5,
                      prof_slide=8)
    full = recon_radial2d(d, cfg)
    halfr = recon_radial2d(d, cfg, half_readback=True)
    np.testing.assert_array_equal(
        np.stack([full.real, full.imag]).astype(np.float16),
        np.stack([halfr.real, halfr.imag]).astype(np.float16),
    )

    cfgk = ReconConfig(golden_angle=True, adjoint=True, data_undersamp=0.5,
                       koosh=True)
    dk = (rng.standard_normal((nc, 1, nro, 16, 3)) +
          1j * rng.standard_normal((nc, 1, nro, 16, 3))).astype(np.complex64)
    fullk = recon_radial2d(dk, cfgk)
    halfk = recon_radial2d(dk, cfgk, half_readback=True)
    np.testing.assert_array_equal(
        np.stack([fullk.real, fullk.imag]).astype(np.float16),
        np.stack([halfk.real, halfk.imag]).astype(np.float16),
    )


def test_stream_compress_matches_in_memory(tmp_path, rng):
    """--stream --compress: the streamed path computes the virtual-coil
    basis from a disk-only Gram pass (recon._stream_coil_basis) and
    projects each block before upload; the in-memory path compresses on
    device.  Both keep the same top-ncomp subspace, and SoS is invariant
    under any unitary basis choice within it, so the combined images must
    agree across several blocks incl. the realigned tail."""
    nc, nro, npe1 = 6, 32, 200
    base = (rng.standard_normal((2, 1, nro, npe1, 1)) +
            1j * rng.standard_normal((2, 1, nro, npe1, 1))).astype(np.complex64)
    base[1] *= 0.3          # distinct eigenvalues -> well-defined subspace
    mix = (rng.standard_normal((nc, 2)) +
           1j * rng.standard_normal((nc, 2))).astype(np.complex64)
    d = np.einsum("ck,ktrpz->ctrpz", mix, base).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--compress", "2", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    assert ra_query(a).dims == ra_query(b).dims
    xa, xb = np.abs(ra_read(a)), np.abs(ra_read(b))
    np.testing.assert_allclose(xa, xb, rtol=2e-3, atol=1e-4 * float(xa.max()))


def test_stream_compress_combine_none(tmp_path, rng):
    """--stream --compress --combine none writes ncomp virtual-coil frames
    region-by-region; the per-pixel coil-vector NORM (basis-invariant)
    must match the in-memory compressed path."""
    nc, nro, npe1 = 4, 32, 120
    base = (rng.standard_normal((2, 1, nro, npe1, 1)) +
            1j * rng.standard_normal((2, 1, nro, npe1, 1))).astype(np.complex64)
    base[1] *= 0.25
    mix = (rng.standard_normal((nc, 2)) +
           1j * rng.standard_normal((nc, 2))).astype(np.complex64)
    d = np.einsum("ck,ktrpz->ctrpz", mix, base).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-u", "0.5", "-d", "4", "--compress", "2",
            "--combine", "none", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims and ha.dims[0] == 2  # ncomp virtual coils
    na = np.linalg.norm(ra_read(a), axis=0)
    nb = np.linalg.norm(ra_read(b), axis=0)
    np.testing.assert_allclose(na, nb, rtol=2e-3, atol=1e-4 * float(na.max()))


def test_stream_coil_basis_chunked(tmp_path, rng):
    """_stream_coil_basis: the chunked disk Gram must equal the one-shot
    whole-file Gram (same eigenbasis) regardless of chunk size, per
    repetition."""
    from tron_jax.recon import _stream_coil_basis

    nc, nt, nro, npe1 = 3, 2, 16, 50
    d = (rng.standard_normal((nc, nt, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, nt, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    b1 = _stream_coil_basis(p, npe1, 2, chunk=7)
    b2 = _stream_coil_basis(p, npe1, 2, chunk=npe1)
    assert b1.shape == (nt, nc, 2)
    # eigenvectors are phase-ambiguous; compare projectors P = B B^H
    for t in range(nt):
        P1 = b1[t] @ b1[t].conj().T
        P2 = b2[t] @ b2[t].conj().T
        np.testing.assert_allclose(P1, P2, atol=1e-5)


def test_stream_walsh_and_cgnr(tmp_path, rng):
    """--stream dispatches whatever recon_frames does per frame — Walsh
    combine and CGNR (-i) included; both must match their in-memory
    counterparts across blocks."""
    nc, nro, npe1 = 2, 32, 120
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    for extra in (["--combine", "walsh"], ["-i", "2"]):
        a = tmp_path / f"a{extra[-1]}.ra"
        b = tmp_path / f"b{extra[-1]}.ra"
        args = ["-a", "-G", "-u", "0.5", "-d", "4", *extra, str(p)]
        assert main(args + [str(a)]) == 0
        assert main(args + [str(b), "--stream"]) == 0
        assert ra_query(a).dims == ra_query(b).dims
        np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-4, atol=1e-5)


def test_stream_koosh_matches_in_memory(tmp_path, rng):
    """-3 --stream: the npe1-blocked streamed stack-of-stars driver must
    write the same file as the in-memory -3 path (slice-major frame order,
    region writes)."""
    nc, nro, npe1, npe2 = 2, 32, 72, 3
    d = (rng.standard_normal((nc, 1, nro, npe1, npe2)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, npe2))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-3", "-u", "0.5", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims == (1, 1, 16, 16, npe2 * 4)
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)


def test_stream_koosh_half(tmp_path, rng):
    """-3 --stream --half: f16 re/im-pair region writes must match the
    in-memory -3 --half file exactly."""
    nc, nro, npe1, npe2 = 2, 32, 48, 4
    d = (rng.standard_normal((nc, 1, nro, npe1, npe2)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, npe2))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-3", "-u", "0.5", "--half", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    ha, hb = ra_query(a), ra_query(b)
    assert ha.dims == hb.dims and ha.dims[0] == 2
    assert ha.dtype == np.float16
    np.testing.assert_array_equal(ra_read(a), ra_read(b))


def test_stream_koosh_fp16_pair_input(tmp_path, rng):
    """-3 --stream over an fp16 re/im-pair input (the --half output
    convention): the stride-aware stack reader must decode it the same as
    the in-memory path."""
    nc, nro, npe1, npe2 = 2, 32, 48, 3
    d = (rng.standard_normal((nc, 1, nro, npe1, npe2)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, npe2))).astype(np.complex64)
    pair = np.stack([d.real, d.imag]).astype(np.float16)
    p = tmp_path / "d16.ra"
    ra_write(pair, p)
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    args = ["-a", "-G", "-3", "-u", "0.5", str(p)]
    assert main(args + [str(a)]) == 0
    assert main(args + [str(b), "--stream"]) == 0
    assert ra_query(a).dims == ra_query(b).dims
    np.testing.assert_allclose(ra_read(a), ra_read(b), rtol=2e-5, atol=1e-6)
