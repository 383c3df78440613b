"""Parity on the card at real widths (skipped without a GPU; chip_smoke.py
runs these, or ``TRON_GPU_TESTS=1 python -m pytest -m gpu tests/``).

Frames: the whole-body frame (6 coils, 204 golden-angle spokes x 512
readouts, 512^2 grid) of phantom x birdcage data, and the same frame at
osf 1.5 / 2.5 and at kernel half-width 3.  References: the plain XLA
gridder and a direct-sum degrid, both at precision HIGHEST (fp32, no TF32),
and the exact-DTFT oracle.

Bounds, with the precision each holds at:
  * gridder, fast (TF32 products, fp32 sums):     NRMSE <= 1e-3
  * gridder, accurate (fp32 products and sums):   NRMSE <= 1e-5
  * gather degrid vs the direct sum:              NRMSE <= 1e-5
  * adjoint pipeline vs the DTFT oracle:          NRMSE <= 1e-3 (the
    method's own floor is about 4e-4)
  * CGNR pair dot test, accurate:                 relative error <= 1e-4
They absorb TF32 rounding and the other order of the sums on the card.
"""

import functools

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

NC, NPE, NRO = 6, 204, 512
GEOMETRIES = {
    "whole_body": (2.0, 2.0),
    "osf1.5": (1.5, 2.0),
    "osf2.5": (2.5, 2.0),
    "kw3": (2.0, 3.0),
}


def _nrmse(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _frame(gridos, kw):
    """Density-compensated samples of one frame, its angles and config."""
    import jax
    import jax.numpy as jnp

    from tron_jax.config import ReconConfig
    from tron_jax.nufft import nufft_forward, sdc_weights
    from tron_jax.phantom import birdcage_sensitivities, shepp_logan
    from tron_jax.trajectory import spoke_angles

    n = NRO // 2
    cfg = ReconConfig(golden_angle=True, gridos=gridos, kernwidth=kw, adjoint=True)
    img = jnp.asarray(shepp_logan(n)[None] * birdcage_sensitivities(n, NC))
    angles = spoke_angles(NPE, "golden", 21)
    data = jax.jit(lambda x: nufft_forward(x, angles, cfg, nro=NRO))(img)
    data = data * sdc_weights(cfg, NRO, NPE).astype(data.dtype)
    return data, angles, cfg


def _grid(precision, gridos, kw):
    import jax

    from tron_jax.kernels.kb import kb_beta
    from tron_jax.ops.grid import grid_radial2d
    from tron_jax.ops.grid_triton import grid_radial2d_triton

    data, angles, _ = _frame(gridos, kw)
    nxos = int((NRO // 2) * gridos)
    beta = kb_beta(kw, gridos)
    got = jax.jit(lambda d: grid_radial2d_triton(
        d, angles, nxos, kw, beta, precision=precision))(data)
    want = jax.jit(lambda d: grid_radial2d(d, angles, nxos, kw, beta))(data)
    return _nrmse(got, want)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gridder_fast(geometry):
    err = _grid("fast", *GEOMETRIES[geometry])
    print(f"gridder fast {geometry}: nrmse {err:.3e}")
    assert err <= 1e-3


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_gridder_accurate(geometry):
    err = _grid("accurate", *GEOMETRIES[geometry])
    print(f"gridder accurate {geometry}: nrmse {err:.3e}")
    assert err <= 1e-5


@pytest.mark.parametrize("wrap", [True, False])
def test_degrid_gather_vs_direct_sum(rng, wrap):
    """The 25-tap gather vs the separable direct sum over the whole grid."""
    import jax
    import jax.numpy as jnp

    from tron_jax.kernels.kb import kb_beta, kb_kernel
    from tron_jax.ops.degrid import degrid_radial2d
    from tron_jax.trajectory import spoke_angles

    n, kw = NRO, 2.0
    beta = kb_beta(kw, 2.0)
    g = jnp.asarray((rng.standard_normal((NC, n, n)) +
                     1j * rng.standard_normal((NC, n, n))).astype(np.complex64))
    angles = spoke_angles(NPE, "golden", 0)
    got = jax.jit(lambda x: degrid_radial2d(x, angles, NRO, kw, beta, wrap=wrap))(g)

    @jax.jit
    def direct(x):
        kr = (jnp.arange(NRO, dtype=jnp.float32) / NRO - 0.5) * n
        xs = kr[None, :] * jnp.cos(angles)[:, None] + n // 2
        ys = kr[None, :] * jnp.sin(angles)[:, None] + n // 2
        pos = jnp.arange(n, dtype=jnp.float32)

        def w(d):
            if wrap:
                d = jnp.where(d >= n / 2, d - n, jnp.where(d < -n / 2, d + n, d))
            return kb_kernel(d, kw, beta).astype(jnp.complex64)

        def spoke(p):
            A = w(xs[p][:, None] - pos)                    # (nro, x)
            B = w(ys[p][:, None] - pos)                    # (nro, y)
            V = jnp.einsum("rx,cyx->cry", A, x, precision="highest")
            return jnp.einsum("ry,cry->cr", B, V, precision="highest")

        return jnp.moveaxis(jax.lax.map(spoke, jnp.arange(NPE)), 0, 1)

    err = _nrmse(got, direct(g))
    print(f"degrid gather wrap={wrap}: nrmse {err:.3e}")
    assert err <= 1e-5


def test_adjoint_pipeline_vs_dtft_oracle():
    """Accurate-mode adjoint (kernel + cuFFT + crop + deapod) vs the exact
    DTFT adjoint of the same samples, one coil at the whole-body width."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tron_jax.nufft import nufft_adjoint
    from tron_jax.oracle.dtft import dtft2_adjoint_chunked

    data, angles, cfg = _frame(2.0, 2.0)
    cfg = dataclasses.replace(cfg, precision="accurate")
    d = data[:1].at[..., 0].set(0)
    n, nxos = NRO // 2, NRO
    rec = jax.jit(lambda x: nufft_adjoint(x, angles, cfg, apply_sdc=False))(d)
    kr = (jnp.arange(NRO, dtype=jnp.float32) / NRO - 0.5) * nxos
    kx = (kr[None, :] * jnp.cos(angles)[:, None]).reshape(-1)
    ky = (kr[None, :] * jnp.sin(angles)[:, None]).reshape(-1)
    orc = jax.jit(lambda s: dtft2_adjoint_chunked(s, kx, ky, n, nxos))(
        d[0].reshape(-1)) / (nxos * NPE)
    err = _nrmse(rec[0], orc)
    print(f"adjoint vs DTFT oracle: nrmse {err:.3e}")
    assert err <= 1e-3


@pytest.mark.parametrize("gridos", [2.0, 1.5])
def test_cgnr_pair_dot_test(rng, gridos):
    """<A x, W y> = <x, A^H W y> for the solver's pair in accurate mode:
    the Triton gridder against the clip-mode gather degrid."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tron_jax.nufft import nufft_adjoint_exact, nufft_forward

    _, angles, cfg = _frame(gridos, 2.0)
    cfg = dataclasses.replace(cfg, precision="accurate")
    n = NRO // 2
    nxos = int(n * gridos)
    x = jnp.asarray((rng.standard_normal((NC, n, n)) +
                     1j * rng.standard_normal((NC, n, n))).astype(np.complex64))
    y = jnp.asarray((rng.standard_normal((NC, NPE, NRO)) +
                     1j * rng.standard_normal((NC, NPE, NRO))).astype(np.complex64))
    y = y.at[..., 0].set(0)
    Ax = jax.jit(lambda v: nufft_forward(v, angles, cfg, nro=NRO, wrap=False))(x)
    AHy = jax.jit(lambda v: nufft_adjoint_exact(v, angles, cfg))(y) * (nxos * NPE)
    lhs = complex(jnp.vdot(y, Ax))
    rhs = complex(jnp.vdot(AHy, x))
    rel = abs(lhs - rhs) / abs(rhs)
    print(f"pair dot test gridos={gridos}: rel {rel:.3e}")
    assert rel <= 1e-4


def test_incremental_matches_direct_on_the_card(rng):
    """The telescoping scan through the kernel, 64 whole-body frames."""
    import jax.numpy as jnp

    from tron_jax.config import ReconConfig
    from tron_jax.recon import recon_frames, recon_frames_incremental

    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21,
                      adjoint=True)
    nz = 64
    npe1 = NPE + (nz - 1) * 21
    d = jnp.asarray((rng.standard_normal((NC, npe1, NRO)) +
                     1j * rng.standard_normal((NC, npe1, NRO))).astype(np.complex64))
    a = np.asarray(recon_frames(d, cfg, NPE, 21, nz))
    b = np.asarray(recon_frames_incremental(d, cfg, NPE, 21, nz))
    worst = max(_nrmse(b[z], a[z]) for z in range(nz))
    print(f"incremental vs direct, {nz} frames: worst nrmse {worst:.3e}")
    assert worst <= 1e-4
