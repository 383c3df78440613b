"""ReconConfig knobs and the gridder's one choice point.

nufft.grid_backend is keyed on jax.default_backend(): the GPU gets the
Triton kernel, the CPU the plain XLA gridder, any other platform an error;
backend="pallas" off the GPU runs only in the interpreter.
"""

import functools

import jax
import pytest

from tron_jax import nufft
from tron_jax.config import AngleScheme, ReconConfig
from tron_jax.ops.grid import grid_radial2d
from tron_jax.ops.grid_triton import grid_radial2d_triton


def _on(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)


def _target(fn):
    assert isinstance(fn, functools.partial)
    return fn.func, fn.keywords


def test_auto_on_gpu_is_the_kernel(monkeypatch):
    _on(monkeypatch, "gpu")
    func, kw = _target(nufft.grid_backend(ReconConfig(precision="accurate")))
    assert func is grid_radial2d_triton
    assert kw["precision"] == "accurate" and kw["interpret"] is False


def test_auto_on_cpu_is_plain(monkeypatch):
    _on(monkeypatch, "cpu")
    func, kw = _target(nufft.grid_backend(ReconConfig(pe_chunk=3)))
    assert func is grid_radial2d and kw["pe_chunk"] == 3


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_auto_elsewhere_raises(monkeypatch, platform):
    _on(monkeypatch, platform)
    with pytest.raises(RuntimeError, match="no gridder"):
        nufft.grid_backend(ReconConfig())


def test_pallas_off_gpu_raises(monkeypatch):
    _on(monkeypatch, "cpu")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        nufft.grid_backend(ReconConfig(backend="pallas"))


def test_pallas_interpreted_off_gpu(monkeypatch):
    _on(monkeypatch, "cpu")
    func, kw = _target(
        nufft.grid_backend(ReconConfig(backend="pallas", interpret=True))
    )
    assert func is grid_radial2d_triton and kw["interpret"] is True


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_jnp_anywhere(monkeypatch, platform):
    _on(monkeypatch, platform)
    func, _ = _target(nufft.grid_backend(ReconConfig(backend="jnp")))
    assert func is grid_radial2d


@pytest.mark.parametrize("exact", [False, True])
def test_exact_threads_through(monkeypatch, exact):
    _on(monkeypatch, "gpu")
    assert _target(nufft.grid_backend(ReconConfig(), exact=exact))[1]["exact"] is exact
    _on(monkeypatch, "cpu")
    assert _target(nufft.grid_backend(ReconConfig(), exact=exact))[1]["raw_rows"] is exact


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        nufft.grid_backend(ReconConfig(backend="mxu"))


def test_cgnr_auto_operators_follow_the_platform(monkeypatch):
    """operators='auto' resolves to the pair on a GPU: with the kernel
    interpreted, the solve must equal an explicit 'pair' solve on the CPU."""
    import jax.numpy as jnp
    import numpy as np

    from tron_jax.solver import cgnr_radial2d
    from tron_jax.trajectory import spoke_angles

    rng = np.random.default_rng(0)
    d = jnp.asarray((rng.standard_normal((1, 8, 32)) +
                     1j * rng.standard_normal((1, 8, 32))).astype(np.complex64))
    angles = spoke_angles(8, AngleScheme.GOLDEN, 0)
    cfg = ReconConfig(golden_angle=True, niter=3, backend="pallas", interpret=True)
    want = np.asarray(cgnr_radial2d(d, angles, cfg, operators="pair"))
    _on(monkeypatch, "gpu")
    got = np.asarray(cgnr_radial2d(d, angles, cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_config_defaults():
    cfg = ReconConfig()
    assert (cfg.backend, cfg.precision, cfg.interpret) == ("auto", "fast", False)
    assert (cfg.frame_block, cfg.inc_block) == (1, 1)
    hash(cfg)  # static jit argument


def test_frame_geometry_whole_body():
    """-u 0.4 -d 21 on 512 x 20271 profiles: 204 spokes, 956 frames
    (`src/tron.cu:916-928`)."""
    cfg = ReconConfig(golden_angle=True, data_undersamp=0.4, prof_slide=21)
    assert cfg.frame_geometry(512, 20271) == (204, 21, 956)


def test_scheme_for_defaults_and_override():
    cfg = ReconConfig()
    assert cfg.scheme_for("adjoint") == AngleScheme.LINEAR_FULL
    assert cfg.scheme_for("forward") == AngleScheme.LINEAR_HALF
    assert ReconConfig(angle_scheme="linear_half").scheme_for("adjoint") == "linear_half"
    assert ReconConfig(golden_angle=True).scheme_for("forward") == AngleScheme.GOLDEN
