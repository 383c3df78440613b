"""Coil combination tests."""

import numpy as np
import jax.numpy as jnp

from tron_jax.ops.coil import coil_combine_sos, coil_combine_walsh, _box_filter


def test_sos_basic(rng):
    x = (rng.standard_normal((4, 8, 8)) + 1j * rng.standard_normal((4, 8, 8))).astype(np.complex64)
    got = np.asarray(coil_combine_sos(jnp.asarray(x)))
    want = np.sqrt((np.abs(x) ** 2).sum(0))
    np.testing.assert_allclose(got.real, want, rtol=1e-5)
    np.testing.assert_allclose(got.imag, 0, atol=1e-6)


def test_sos_single_channel_passthrough(rng):
    x = (rng.standard_normal((1, 8, 8)) + 1j * rng.standard_normal((1, 8, 8))).astype(np.complex64)
    got = np.asarray(coil_combine_sos(jnp.asarray(x)))
    np.testing.assert_array_equal(got, x[0])


def test_box_filter_matches_naive(rng):
    x = rng.standard_normal((6, 6)).astype(np.float32)
    got = np.asarray(_box_filter(jnp.asarray(x), 1))
    want = np.zeros_like(x)
    for i in range(6):
        for j in range(6):
            want[i, j] = x[max(0, i - 1) : i + 2, max(0, j - 1) : j + 2].sum()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_walsh_recovers_rank1(rng):
    """For coilimg = s_c * m(x,y) (rank-1), Walsh combine should recover
    |s| * m up to a global phase, beating SoS's phase loss."""
    n, C = 16, 4
    m = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    s = (rng.standard_normal(C) + 1j * rng.standard_normal(C)).astype(np.complex64)
    coil = s[:, None, None] * m[None]
    got = np.asarray(coil_combine_walsh(jnp.asarray(coil), npatch=1))
    # compare |got| with ||s|| * |m|
    np.testing.assert_allclose(np.abs(got), np.linalg.norm(s) * np.abs(m), rtol=2e-2, atol=1e-3)


def test_walsh_matches_naive_dense(rng):
    """The Hermitian-unique-plane formulation must match a literal per-pixel
    dense implementation of the same algorithm (full C x C box-filtered
    covariance, 5-step power iteration from the all-ones start, conj(v)
    combine — `src/tron.cu:222-302`)."""
    C, n, npatch, niters = 3, 8, 1, 5
    coil = (
        rng.standard_normal((C, n, n)) + 1j * rng.standard_normal((C, n, n))
    ).astype(np.complex64)

    # dense covariance via the same zero-padded box filter
    outer = np.einsum("ayx,byx->abyx", coil, coil.conj())
    A = np.zeros_like(outer)
    for dy in range(-npatch, npatch + 1):
        for dx in range(-npatch, npatch + 1):
            src = np.zeros_like(outer)
            ys = slice(max(0, dy), n + min(0, dy))
            yd = slice(max(0, -dy), n + min(0, -dy))
            xs = slice(max(0, dx), n + min(0, dx))
            xd = slice(max(0, -dx), n + min(0, -dx))
            src[..., yd, xd] = outer[..., ys, xs]
            A += src
    v = np.ones((C, n, n), np.complex64)
    for _ in range(niters):
        y = np.einsum("abyx,byx->ayx", A, v)
        nrm = np.sqrt((np.abs(y) ** 2).sum(0, keepdims=True))
        v = y / np.where(nrm > 0, nrm, 1.0)
    want = (v.conj() * coil).sum(0)

    got = np.asarray(coil_combine_walsh(jnp.asarray(coil), npatch=npatch, niters=niters))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_walsh_frames_chunking_matches_per_frame(rng):
    """coil_combine_walsh_frames (lax.map chunked) == per-frame combine,
    including a frame_block that does not divide nz."""
    from tron_jax.ops.coil import coil_combine_walsh_frames

    nz, C, n = 5, 3, 8
    stack = (
        rng.standard_normal((nz, C, n, n)) + 1j * rng.standard_normal((nz, C, n, n))
    ).astype(np.complex64)
    got = np.asarray(coil_combine_walsh_frames(jnp.asarray(stack), 1, frame_block=2))
    want = np.stack(
        [np.asarray(coil_combine_walsh(jnp.asarray(f), 1)) for f in stack]
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_walsh_single_channel(rng):
    x = (rng.standard_normal((1, 8, 8)) + 1j * rng.standard_normal((1, 8, 8))).astype(np.complex64)
    got = np.asarray(coil_combine_walsh(jnp.asarray(x)))
    np.testing.assert_array_equal(got, x[0])


def test_coil_compress_rank_recovery(rng):
    """Data spanning a rank-2 coil subspace compresses to 2 channels with
    no information loss (SoS image preserved)."""
    from tron_jax.ops.coil import coil_compress

    C, npe, nro = 6, 8, 16
    base = (rng.standard_normal((2, npe, nro)) + 1j * rng.standard_normal((2, npe, nro))).astype(np.complex64)
    mix = (rng.standard_normal((C, 2)) + 1j * rng.standard_normal((C, 2))).astype(np.complex64)
    data = jnp.asarray(np.einsum("ck,kpr->cpr", mix, base))

    comp = coil_compress(data, 2)
    assert comp.shape == (2, npe, nro)
    # energy preserved (unitary rotation onto the signal subspace)
    e_full = float(jnp.sum(jnp.abs(data) ** 2))
    e_comp = float(jnp.sum(jnp.abs(comp) ** 2))
    assert abs(e_comp - e_full) / e_full < 1e-4


def test_coil_compress_passthrough(rng):
    from tron_jax.ops.coil import coil_compress

    x = jnp.asarray((rng.standard_normal((3, 4, 8)) + 0j).astype(np.complex64))
    assert coil_compress(x, 5) is x
