"""End-to-end slice: degrid -> grid roundtrip (BASELINE.json configs[0]) and
operator adjointness.

Accuracy structure:
  * implementation parity: fast pipeline vs the exact-DTFT oracle pipeline
    with identical weights — strict (<5e-3), isolates gridding error.
  * physics: with cfg.sdc="ideal" the roundtrip is ~unit-gain and accurate
    on smooth images.  With the reference's Ram-Lak weights the +1/npe
    intercept biases the lowest frequencies (a documented reference
    property), so truth-comparisons there are lenient sanity checks only.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.nufft import nufft_adjoint, nufft_forward, sdc_weights
from tron_jax.oracle import dtft2, dtft2_adjoint
from tron_jax.phantom import shepp_logan
from tron_jax.trajectory import spoke_angles
from tests.conftest import lmse, nrmse


def _gaussian(n):
    c = (np.arange(n) - n // 2) / (n / 2)
    X, Y = np.meshgrid(c, c)
    return np.exp(-((X - 0.2) ** 2 + (Y + 0.1) ** 2) / 0.05).astype(np.complex64)


def _kxy(nro, nxos, angles):
    kr = (np.arange(nro) / nro - 0.5) * nxos
    kx = (kr[None, :] * np.cos(angles)[:, None]).ravel().astype(np.float32)
    ky = (kr[None, :] * np.sin(angles)[:, None]).ravel().astype(np.float32)
    return kx, ky


def test_roundtrip_matches_oracle_roundtrip():
    """Fast degrid->grid vs DTFT->adjoint-DTFT with identical SDC weights:
    pure implementation error."""
    n, npe = 32, 64
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    nro = nxos = 2 * n
    img = shepp_logan(n)
    angles = np.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    kx, ky = _kxy(nro, nxos, angles)

    data = nufft_forward(jnp.asarray(img), jnp.asarray(angles), cfg)
    rec = np.asarray(nufft_adjoint(data, jnp.asarray(angles), cfg))

    w = np.asarray(sdc_weights(cfg, nro, npe))
    oracle_data = np.asarray(dtft2(jnp.asarray(img), jnp.asarray(kx), jnp.asarray(ky), nxos))
    oracle_data = oracle_data.reshape(npe, nro) * w
    # align the one convention difference: the gridder never uses readout 0
    oracle_data[:, 0] = 0
    oracle_rec = np.asarray(
        dtft2_adjoint(jnp.asarray(oracle_data.ravel()), jnp.asarray(kx), jnp.asarray(ky), n, nxos)
    ) / (nxos * npe)

    err = nrmse(rec, oracle_rec)
    assert err < 5e-3, f"pipeline vs oracle pipeline nrmse={err:.2e}"


def test_roundtrip_ideal_dcf_unit_gain():
    """With exact polar density weights the roundtrip is ~identity."""
    n, npe = 64, 128
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF, sdc="ideal")
    img = _gaussian(n)
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))
    data = nufft_forward(jnp.asarray(img), angles, cfg)
    rec = np.asarray(nufft_adjoint(data, angles, cfg))
    scale = np.vdot(rec.ravel(), img.ravel()).real / np.vdot(rec.ravel(), rec.ravel()).real
    assert abs(scale - 1.0) < 0.05, f"gain {1/scale:.3f} != 1"
    assert lmse(rec, img) < 0.03


def test_roundtrip_shepplogan_sanity():
    """Lenient truth checks (catch transposes/shifts/scale blunders); the
    residual here is Gibbs ringing + Ram-Lak LF bias, both expected."""
    n, npe = 64, 128
    img = shepp_logan(n)
    for cfg, skip in [
        (ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF), 0),
        (ReconConfig(golden_angle=True, skip_angles=11), 11),
    ]:
        scheme = cfg.scheme_for("adjoint")
        angles = jnp.asarray(spoke_angles(npe, scheme, skip))
        data = nufft_forward(jnp.asarray(img), angles, cfg)
        rec = np.asarray(nufft_adjoint(data, angles, cfg))
        err = lmse(rec, img)
        assert err < 0.35, f"{scheme} roundtrip lmse={err:.3f}"
        # structural agreement (catches transposes/shifts): |rec| must
        # correlate strongly with the phantom magnitude
        a = np.abs(rec).ravel() - np.abs(rec).mean()
        b = np.abs(img).ravel() - np.abs(img).mean()
        corr = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert corr > 0.9, f"{scheme} correlation {corr:.3f}"


def test_forward_adjoint_dot_test(rng):
    """<y, A x> == <A^H y, x> for the exact transpose, and the fast gridding
    adjoint agrees with it on interior-supported data."""
    n, npe = 16, 20
    cfg = ReconConfig(angle_scheme=AngleScheme.LINEAR_HALF)
    nro = 2 * n
    angles = jnp.asarray(spoke_angles(npe, AngleScheme.LINEAR_HALF))

    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    y = (rng.standard_normal((npe, nro)) + 1j * rng.standard_normal((npe, nro))).astype(
        np.complex64
    )
    # keep y supported away from the grid edge and off readout 0, where the
    # forward (periodic wrap) and adjoint (clamped band) differ by convention
    ro = np.arange(nro)
    mask = (np.abs(ro - nro // 2) <= n - 4) & (ro != 0)
    y *= mask

    fwd = lambda im: nufft_forward(im, angles, cfg, nro=nro)
    Ax = fwd(jnp.asarray(x))
    At = jax.linear_transpose(fwd, jnp.asarray(x))
    (Aty,) = At(jnp.asarray(np.conj(y)))
    Aty = np.conj(np.asarray(Aty))
    lhs = np.vdot(y, np.asarray(Ax))
    rhs = np.vdot(Aty, x)
    assert abs(lhs - rhs) / abs(lhs) < 5e-4  # fp32 reduction noise

    adj = nufft_adjoint(jnp.asarray(y), angles, cfg, apply_sdc=False)
    adj = np.asarray(adj) * (2 * n * npe)
    assert nrmse(adj, Aty) < 5e-4


def test_recon_frames_sliding_window(rng):
    """Frame scheduler: sliding window recon matches per-frame manual calls."""
    from tron_jax.recon import recon_frames

    n, nc = 16, 2
    nro = 2 * n
    npe1, work, slide = 24, 12, 6
    cfg = ReconConfig(golden_angle=True, data_undersamp=work / nro, prof_slide=slide)
    w, s, nz = cfg.frame_geometry(nro, npe1)
    assert (w, s) == (work, slide) and nz == 3

    data = (rng.standard_normal((nc, npe1, nro)) + 1j * rng.standard_normal((nc, npe1, nro))).astype(np.complex64)
    out = np.asarray(recon_frames(jnp.asarray(data), cfg, w, s, nz))
    assert out.shape == (nz, n, n)

    from tron_jax.recon import reconstruct_frame

    for z in range(nz):
        win = data[:, z * slide : z * slide + work]
        ref = np.asarray(reconstruct_frame(jnp.asarray(win), jnp.asarray(z * slide), cfg))
        np.testing.assert_allclose(out[z], ref, rtol=2e-4, atol=2e-6)


def test_recon_frames_incremental_matches_direct(rng):
    """Telescoping sliding-window path: identical images to recon_frames
    (fp32 accumulation-order noise only).  Covers many frames so carry
    drift would show, plus the skip0 streaming offset."""
    import dataclasses

    from tron_jax.recon import (
        incremental_applicable,
        recon_frames,
        recon_frames_incremental,
    )

    nc, nro, npe1 = 3, 32, 92
    cfg = ReconConfig(
        adjoint=True, golden_angle=True, data_undersamp=0.5, prof_slide=4,
        backend="jnp",
    )
    work, slide, nz = cfg.frame_geometry(nro, npe1)
    assert (work, slide, nz) == (16, 4, 20)
    assert incremental_applicable(cfg, work, slide, nz)

    data = (
        rng.standard_normal((nc, npe1, nro))
        + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)
    d = jnp.asarray(data)
    for skip0 in (0, 7):
        a = np.asarray(recon_frames(d, cfg, work, slide, nz, skip0))
        b = np.asarray(recon_frames_incremental(d, cfg, work, slide, nz, skip0))
        assert b.shape == a.shape
        worst = max(
            np.linalg.norm(b[z] - a[z]) / np.linalg.norm(a[z]) for z in range(nz)
        )
        assert worst < 1e-5, worst

    # non-telescoping cases must be rejected by the gate
    assert not incremental_applicable(cfg, work, work, 2)        # no overlap
    assert not incremental_applicable(
        dataclasses.replace(cfg, golden_angle=False), work, slide, nz
    )                                                            # linear angles
    assert not incremental_applicable(
        dataclasses.replace(cfg, niter=2), work, slide, nz
    )                                                            # CGNR


def test_recon_radial2d_incremental_driver(rng):
    """cfg.incremental through the host driver: nt > 1, every combine mode,
    and the silent fallback for a non-applicable (linear-angle) config."""
    import dataclasses

    from tron_jax.recon import recon_radial2d

    nc, nt, nro, npe1 = 2, 2, 32, 48
    data = (
        rng.standard_normal((nc, nt, nro, npe1, 1))
        + 1j * rng.standard_normal((nc, nt, nro, npe1, 1))
    ).astype(np.complex64)
    base = ReconConfig(
        adjoint=True, golden_angle=True, data_undersamp=0.5, prof_slide=4,
        backend="jnp",
    )
    for combine in ("sos", "walsh", "none"):
        cfg0 = dataclasses.replace(base, coil_combine=combine)
        cfg1 = dataclasses.replace(cfg0, incremental=True)
        a = recon_radial2d(data, cfg0)
        b = recon_radial2d(data, cfg1)
        assert np.linalg.norm(b - a) / np.linalg.norm(a) < 1e-5

    cfg_lin = dataclasses.replace(base, golden_angle=False, incremental=True)
    cfg_lin0 = dataclasses.replace(cfg_lin, incremental=False)
    assert np.array_equal(recon_radial2d(data, cfg_lin0), recon_radial2d(data, cfg_lin))


def test_incremental_block_size_invariance(rng):
    """inc_block (frames per telescoping scan step, a pure perf knob) must
    not change values: the per-frame cumulative addition order is identical
    at any block size."""
    import dataclasses

    from tron_jax.recon import recon_frames_incremental

    nc, nro, npe1 = 2, 32, 92
    cfg0 = ReconConfig(
        adjoint=True, golden_angle=True, data_undersamp=0.5, prof_slide=4,
        backend="jnp",
    )
    work, slide, nz = cfg0.frame_geometry(nro, npe1)
    data = (
        rng.standard_normal((nc, npe1, nro))
        + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)
    d = jnp.asarray(data)

    outs = []
    for bs in (1, 3, 8):
        cfg = dataclasses.replace(cfg0, inc_block=bs)
        outs.append(np.asarray(
            recon_frames_incremental(d, cfg, work, slide, nz)
        ))
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=2e-6, atol=1e-7)


def test_direct_frame_block_invariance(rng):
    """frame_block (direct-path lax.map batch, a pure perf knob) must not
    change recon_frames' values."""
    import dataclasses

    from tron_jax.recon import recon_frames

    nc, nro, npe1 = 2, 32, 64
    cfg0 = ReconConfig(
        adjoint=True, golden_angle=True, data_undersamp=0.5, prof_slide=8,
        backend="jnp",
    )
    work, slide, nz = cfg0.frame_geometry(nro, npe1)
    data = (
        rng.standard_normal((nc, npe1, nro))
        + 1j * rng.standard_normal((nc, npe1, nro))
    ).astype(np.complex64)
    d = jnp.asarray(data)
    outs = [
        np.asarray(recon_frames(
            d,
            dataclasses.replace(cfg0, frame_block=fb),
            work, slide, nz,
        ))
        for fb in (1, 4, 8)
    ]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=2e-6, atol=1e-7)
