"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the sharded
frames x coils recon must match the single-device scheduler exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tron_jax.config import ReconConfig
from tron_jax.parallel import make_mesh, recon_frames_sharded
from tron_jax.recon import recon_frames

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices (see conftest)"
)


def _mkdata(rng, nc, npe1, nro):
    return (
        rng.standard_normal((nc, npe1, nro)) + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)


def test_frame_sharded_matches_local(rng):
    nro, npe1, nc = 32, 40, 2
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4)
    work, slide, nz = cfg.frame_geometry(nro, npe1)  # work=16, nz=7
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=8, n_coil=1)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    assert got.shape == want.shape == (nz, nro // 2, nro // 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_frame_coil_2d_mesh(rng):
    nro, npe1, nc = 32, 24, 4
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=8)
    work, slide, nz = cfg.frame_geometry(nro, npe1)  # nz=2
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=4, n_coil=2)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_coil_only_mesh(rng):
    nro, npe1, nc = 32, 16, 8
    cfg = ReconConfig(golden_angle=True)
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=1, n_coil=8)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_sharded_incremental_matches_direct(rng):
    """The per-shard telescoping branch of _sharded_step (use_inc,
    parallel/mesh.py) — CLI-reachable via --shard --incremental — must match
    the direct sharded path, including a nonzero skip0 block offset (the
    --stream --shard composition) and a non-sos combine."""
    import dataclasses

    nro, npe1, nc = 32, 44, 2
    cfg = ReconConfig(
        golden_angle=True, data_undersamp=0.5, prof_slide=4, incremental=True
    )
    work, slide, nz = cfg.frame_geometry(nro, npe1)  # work=16, nz=8
    assert 0 < slide < work and nz > 1  # telescoping actually applies
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=4, n_coil=2)
    for combine in ("sos", "none"):
        cfg_c = dataclasses.replace(cfg, coil_combine=combine)
        cfg_d = dataclasses.replace(cfg_c, incremental=False)
        for skip0 in (0, 13):
            got = np.asarray(
                recon_frames_sharded(
                    jnp.asarray(data), cfg_c, mesh, work, slide, nz,
                    skip0=jnp.int32(skip0),
                )
            )
            want = np.asarray(
                recon_frames_sharded(
                    jnp.asarray(data), cfg_d, mesh, work, slide, nz,
                    skip0=jnp.int32(skip0),
                )
            )
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_sharded_cgnr(rng):
    """CGNR inside the sharded worker (iterative mode, coil psum combine)."""
    nro, npe1, nc = 32, 16, 2
    cfg = ReconConfig(golden_angle=True, niter=2)
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=4, n_coil=2)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)


def test_sharded_walsh_combine(rng):
    """Walsh combine under a coil-sharded mesh (all_gather of coil shards)
    must match the local Walsh path (up to the eigenvector's global phase,
    which Walsh fixes to the first coil — identical on both paths)."""
    nro, npe1, nc = 32, 24, 4
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=8,
                      coil_combine="walsh")
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=4, n_coil=2)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_sharded_combine_none(rng):
    """combine='none' keeps the coil axis, sharded over 'coil'."""
    nro, npe1, nc = 32, 24, 4
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=8,
                      coil_combine="none")
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    data = _mkdata(rng, nc, npe1, nro)

    mesh = make_mesh(n_frame=4, n_coil=2)
    got = np.asarray(recon_frames_sharded(jnp.asarray(data), cfg, mesh, work, slide, nz))
    want = np.asarray(recon_frames(jnp.asarray(data), cfg, work, slide, nz))
    assert got.shape == want.shape == (nz, nc, nro // 2, nro // 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_distributed_single_process_mesh():
    """The DCN bootstrap module degenerates to the local mesh on one
    process (frame axis = all devices), and its frame slice covers nz."""
    from tron_jax.parallel import distributed

    mesh = distributed.make_global_mesh(n_coil=2)
    assert mesh.shape == {"frame": 4, "coil": 2}
    s = distributed.process_frame_slice(10)
    assert (s.start, s.stop) == (0, 10)


# ---- spoke-sharded (sequence-parallel) single-frame recon ------------------


def test_spoke_sharded_adjoint_matches_local(rng):
    """Spokes sharded 8 ways; psum of partial grids must equal the unsharded
    adjoint recon of the same window (npe divides the axis)."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.nufft import nufft_adjoint
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 48, 3
    cfg = ReconConfig(golden_angle=True)
    data = _mkdata(rng, nc, npe, nro)

    mesh = make_spoke_mesh(8)
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))

    angles = spoke_angles(npe, "golden", 0)
    coil = nufft_adjoint(jnp.asarray(data), angles, cfg)
    want = np.asarray(jnp.sqrt(jnp.sum(jnp.abs(coil) ** 2, axis=0)))
    assert got.shape == want.shape == (nro // 2, nro // 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_spoke_sharded_padding_and_linear_scheme(rng):
    """npe=42 does not divide 8 (zero-padded spokes) and the linear-full
    scheme derives angles from the GLOBAL npe."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.nufft import nufft_adjoint
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 42, 2
    cfg = ReconConfig(golden_angle=False)
    data = _mkdata(rng, nc, npe, nro)

    mesh = make_spoke_mesh(8)
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))

    angles = spoke_angles(npe, cfg.scheme_for("adjoint"), 0)
    coil = nufft_adjoint(jnp.asarray(data), angles, cfg)
    want = np.asarray(jnp.sqrt(jnp.sum(jnp.abs(coil) ** 2, axis=0)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_spoke_sharded_cgnr_matches_local(rng):
    """CGNR with spokes sharded: A^H W (.) psums over 'spoke' and the
    solution must match the unsharded solver on the same window (incl. a
    padded spoke count, exercising the sample_mask zero-weighting)."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.solver import cgnr_radial2d
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 42, 2
    cfg = ReconConfig(golden_angle=True, niter=3, coil_combine="none")
    data = _mkdata(rng, nc, npe, nro)

    mesh = make_spoke_mesh(8)
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))

    angles = spoke_angles(npe, "golden", 0)
    want = np.asarray(cgnr_radial2d(jnp.asarray(data), angles, cfg))
    assert got.shape == want.shape == (nc, nro // 2, nro // 2)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)


def test_spoke_sharded_cgnr_toeplitz(rng):
    """--toeplitz under spoke sharding: the Fourier multiplier psums once at
    setup; iterations are collective-free and match the unsharded Toeplitz
    solve."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.solver import cgnr_radial2d
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 40, 1
    cfg = ReconConfig(golden_angle=True, niter=3, toeplitz=True,
                      coil_combine="none")
    data = _mkdata(rng, nc, npe, nro)

    mesh = make_spoke_mesh(8)
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))

    angles = spoke_angles(npe, "golden", 0)
    want = np.asarray(cgnr_radial2d(jnp.asarray(data), angles, cfg))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)


def test_spoke_coil_2d_mesh(rng):
    """SP x TP: spokes AND coils sharded (4 x 2 mesh).  The coil combine
    psums over 'coil' on top of the spoke-grid psum."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.nufft import nufft_adjoint
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 44, 4
    cfg = ReconConfig(golden_angle=True)
    data = _mkdata(rng, nc, npe, nro)

    mesh = make_spoke_mesh(4, n_coil=2)
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))

    angles = spoke_angles(npe, "golden", 0)
    coil = nufft_adjoint(jnp.asarray(data), angles, cfg)
    want = np.asarray(jnp.sqrt(jnp.sum(jnp.abs(coil) ** 2, axis=0)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_spoke_coil_cgnr_and_walsh(rng):
    """SP x TP with CGNR (coil-psum'd inner products + spoke-psum'd A^H W)
    and with the Walsh combine (coil all_gather after the sharded step)."""
    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.ops.coil import coil_combine_walsh
    from tron_jax.solver import cgnr_radial2d
    from tron_jax.trajectory import spoke_angles

    nro, npe, nc = 32, 40, 4
    data = _mkdata(rng, nc, npe, nro)
    angles = spoke_angles(npe, "golden", 0)
    mesh = make_spoke_mesh(4, n_coil=2)

    cfg = ReconConfig(golden_angle=True, niter=2, coil_combine="none")
    got = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfg, mesh))
    want = np.asarray(cgnr_radial2d(jnp.asarray(data), angles, cfg))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)

    cfgw = ReconConfig(golden_angle=True, coil_combine="walsh")
    goth = np.asarray(recon_window_spoke_sharded(jnp.asarray(data), cfgw, mesh))
    from tron_jax.nufft import nufft_adjoint

    coil = nufft_adjoint(jnp.asarray(data), angles, cfgw)
    wanth = np.asarray(coil_combine_walsh(coil, cfgw.walsh_npatch))
    np.testing.assert_allclose(goth, wanth, rtol=2e-4, atol=1e-5)


def test_forward_sharded_matches_local(rng):
    # frame-sharded forward degrid (2D image series), non-dividing nz
    from tron_jax.parallel import recon_forward_sharded
    from tron_jax.recon import recon_radial2d

    nc, nt, n, nz = 2, 1, 16, 5
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, adjoint=False)
    imgs = (
        rng.standard_normal((nc, nt, n, n, nz))
        + 1j * rng.standard_normal((nc, nt, n, n, nz))
    ).astype(np.complex64)

    mesh = make_mesh(n_frame=4, n_coil=2)
    got = recon_forward_sharded(imgs, cfg, mesh)
    want = recon_radial2d(imgs, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_forward_sharded_koosh(rng):
    # slice-sharded -3 forward: sharded degrids + the replicating kz FFT
    from tron_jax.parallel import recon_forward_sharded
    from tron_jax.recon import recon_radial2d

    nc, nt, n, nz = 2, 1, 16, 6
    cfg = ReconConfig(
        golden_angle=True, data_undersamp=0.5, adjoint=False, koosh=True
    )
    imgs = (
        rng.standard_normal((nc, nt, n, n, nz))
        + 1j * rng.standard_normal((nc, nt, n, n, nz))
    ).astype(np.complex64)

    mesh = make_mesh(n_frame=8, n_coil=1)
    got = recon_forward_sharded(imgs, cfg, mesh)
    want = recon_radial2d(imgs, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# ---- the Triton gridder (interpreted) inside the sharded schedulers --------


@pytest.mark.parametrize("incremental", [False, True])
def test_frame_sharded_through_the_kernel(rng, incremental):
    """--shard on the GPU runs the Pallas kernel under shard_map; here it
    runs interpreted on a 4 x 2 ('frame', 'coil') mesh, direct and
    incremental, against the plain single-device recon."""
    import dataclasses

    nro, npe1, nc = 32, 36, 2
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.5, prof_slide=4,
                      adjoint=True, incremental=incremental)
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    data = jnp.asarray(_mkdata(rng, nc, npe1, nro))
    cfg_k = dataclasses.replace(cfg, backend="pallas", interpret=True)
    got = np.asarray(recon_frames_sharded(
        data, cfg_k, make_mesh(n_frame=4, n_coil=2), work, slide, nz))
    want = np.asarray(recon_frames(data, cfg, work, slide, nz))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_spoke_sharded_through_the_kernel(rng):
    """--shard-spokes -i: the kernel (interpreted) grids each card's spokes
    inside the CGNR pair, against the plain unsharded solve."""
    import dataclasses

    from tron_jax.parallel import make_spoke_mesh, recon_window_spoke_sharded
    from tron_jax.recon import reconstruct_frame

    nro, npe, nc = 32, 20, 2
    cfg = ReconConfig(golden_angle=True, niter=3)
    data = jnp.asarray(_mkdata(rng, nc, npe, nro))
    cfg_k = dataclasses.replace(cfg, backend="pallas", interpret=True)
    got = np.asarray(recon_window_spoke_sharded(data, cfg_k, make_spoke_mesh(4)))
    want = np.asarray(reconstruct_frame(data, 0, cfg))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
