"""Iterative CGNR reconstruction (working, unlike the reference's
`tron_cgnr_radial2d`, which is marked "NOT WORKING CORRECTLY YET" at
`src/tron.cu:670`).

Solves the Ram-Lak-weighted least-squares problem of Knopp et al. 2007
(Intl J Biomed Imaging), the same algorithm the reference attempts:

    min_x || W^(1/2) (A x - b) ||^2      =>      A^H W A x = A^H W b

with A = nufft_forward and W = diag(ramlak).  Two operator modes, both true
adjoint pairs — which is why this CGNR converges where the reference's
does not (it pairs a forward and adjoint that aren't transposes of each
other: sin/cos swap, convention mismatches, SURVEY.md §7):

  * "pair" (the GPU's choice): the gridder (the Triton kernel on a GPU) is
    the transpose of the clip-mode gather degrid, so each CG iteration is
    one degrid and one gridding call (adjoint to ~1e-4 in the dot test).
  * "transpose" (any backend): jax.linear_transpose of the dense forward —
    exact to the last bit.

The loop is a lax.while_loop with a relative-residual stop, fully jittable
and shard_map-compatible (psum'd inner products via reduce_axes).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tron_jax.config import ReconConfig
from tron_jax.nufft import nufft_adjoint, nufft_forward, sdc_weights


def toeplitz_fourier_kernel(
    angles: jnp.ndarray,
    cfg: ReconConfig,
    nro: int,
    method: str = "auto",
    npe_total: int | None = None,
    sample_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Fourier multiplier of the Toeplitz-embedded normal operator.

    For the *exact* radial NUFFT E (DTFT at the sample points), the
    Ram-Lak-weighted normal operator is block-Toeplitz — it depends only on
    pixel offsets:

        (E^H W E x)[p] = sum_{p'} t[p - p'] x[p'],
        t[d] = sum_m w_m exp(+2i pi k_m . d / nro)

    so CGNR iterations need no gridding at all: T applies as one circular
    convolution on a 2n-padded grid (Fessler & Sutton's Toeplitz NUFFT
    trick, which the reference's broken CGNR at `src/tron.cu:658-720` never
    had).  Returns fft2(ifftshift(t)) of shape (2n, 2n) with n = nro // 2.

    ``method``:
      * "nufft" — t computed by the fast adjoint NUFFT itself at doubled
        image size: the doubled-frequency identity
        exp(2i pi k d / nro) = exp(2i pi (2k) d / (2 nro)) means embedding
        the weights at the even readouts of a (npe, 2*nro) array and
        gridding at image size 2n yields exactly t (to NUFFT accuracy,
        ~4e-4 — the same approximation level as the operator it replaces).
        One gridding call per frame, amortized over all iterations.
      * "exact" — t by the exact chunked DTFT adjoint (oracle-grade,
        O((2n)^2 M) flops; for tests and small problems).
      * "auto" — "nufft" when the doubled geometry fits the fast path
        (nro == nxos), else "exact".

    Readout 0 is weighted out, matching the pair-mode operator convention
    (one sample per spoke at the highest |k|, never gridded).

    ``npe_total``/``sample_mask`` support spoke-sharded CGNR
    (parallel/spoke.py): when ``angles`` holds only this shard's spokes,
    the Ram-Lak weights must come from the GLOBAL spoke count and padded
    spokes are zero-weighted; the per-shard kernels then psum to the global
    multiplier (t is linear over samples).
    """
    npe = int(angles.shape[0])
    n = nro // 2
    nxos = int(n * cfg.gridos)
    w = sdc_weights(cfg, nro, npe_total or npe).at[0].set(0)
    w2d = jnp.broadcast_to(w[None, :], (npe, nro))
    if sample_mask is not None:
        w2d = sample_mask.astype(w2d.dtype)[:, None] * w2d
    if method == "auto":
        method = "nufft" if nro == nxos else "exact"
        if method == "exact" and n > 64:
            import warnings

            warnings.warn(
                f"toeplitz_fourier_kernel: gridos={cfg.gridos} != 2 forces "
                f"the exact-DTFT PSF kernel (O((2n)^2 M) flops at n={n}) — "
                "expect a slow per-frame precompute; use gridos=2 for the "
                "fast gridded kernel",
                stacklevel=2,
            )
    elif method == "nufft" and nro != nxos:
        # the doubled-frequency embedding holds ONLY at gridos == 2: the
        # gridder's readout->grid radius map is gridos-dependent, and for
        # any other osf the even-slot samples land at the wrong doubled
        # frequencies (measured: 0.48-1.0 NRMSE vs exact) — refuse rather
        # than return a silently wrong kernel
        raise ValueError(
            f"toeplitz_fourier_kernel(method='nufft') requires gridos == 2 "
            f"(got gridos={cfg.gridos}: nxos={nxos} != nro={nro}); use "
            "method='exact' or 'auto'"
        )

    if method == "exact":
        from tron_jax.oracle.dtft import dtft2_adjoint_chunked

        kr = (jnp.arange(nro, dtype=jnp.float32) / nro - 0.5) * nro
        kx = (kr[None, :] * jnp.cos(angles)[:, None]).reshape(-1)
        ky = (kr[None, :] * jnp.sin(angles)[:, None]).reshape(-1)
        wfull = w2d.astype(jnp.complex64).reshape(-1)
        t = dtft2_adjoint_chunked(wfull, kx, ky, 2 * n, nro)
    else:
        w2 = (
            jnp.zeros((npe, 2 * nro), jnp.complex64)
            .at[:, ::2]
            .set(w2d.astype(jnp.complex64))
        )
        # undo the gridder's 1/(nxos'*npe) reference scale at the DOUBLED
        # geometry: nufft_adjoint sees nro' = 2*nro, so n' = nro and
        # nxos' = int(nro * gridos) (== 2*nro only when gridos == 2)
        t = nufft_adjoint(w2, angles, cfg, apply_sdc=False) * (
            int(nro * cfg.gridos) * npe
        )
    return jnp.fft.fft2(jnp.fft.ifftshift(t, axes=(-2, -1)))


def toeplitz_apply(x: jnp.ndarray, mult: jnp.ndarray) -> jnp.ndarray:
    """Apply the Toeplitz-embedded normal operator: zero-pad the (..., n, n)
    image into the corner of a (2n, 2n) grid, multiply in Fourier space,
    crop back.  The 2n circulant evaluates every offset in [-(n-1), n-1]^2
    without aliasing, so the cropped block is exact."""
    n = x.shape[-1]
    n2 = 2 * n
    xp = jnp.zeros(x.shape[:-2] + (n2, n2), jnp.complex64)
    xp = xp.at[..., :n, :n].set(x)
    y = jnp.fft.ifft2(jnp.fft.fft2(xp) * mult)
    return y[..., :n, :n].astype(x.dtype)


def cgnr_radial2d(
    data: jnp.ndarray,
    angles: jnp.ndarray,
    cfg: ReconConfig,
    niter: int | None = None,
    rtol: float = 1e-6,
    reduce_axes: tuple = (),
    operators: str = "auto",
    spoke_axis: str | None = None,
    npe_total: int | None = None,
    sample_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """data: (..., npe, nro) -> image estimate (..., n, n).

    ``reduce_axes``: mesh axis names to psum the CG inner products over —
    required when channels are sharded (inside shard_map), so every shard
    steps with the *global* alpha/beta; the direct analog of a data-parallel
    gradient allreduce.

    ``spoke_axis``/``npe_total``/``sample_mask``: spoke-sharded CGNR
    (parallel/spoke.py) — ``data``/``angles`` hold only this shard's
    spokes; every CG vector lives in the replicated image domain, so the
    ONLY collective is a psum of A^H W (.) over ``spoke_axis`` (and with
    --toeplitz just one psum of the Fourier multiplier at setup).  The
    Ram-Lak weights come from the global ``npe_total`` and ``sample_mask``
    (0/1 per local spoke) zero-weights shard padding.  ``spoke_axis`` must
    NOT also appear in ``reduce_axes`` — image-domain vectors are already
    replicated along it.

    ``operators``: "pair" uses the explicit forward/adjoint pair (degrid
    and the gridder of nufft.grid_backend); "transpose" uses jax.linear_transpose of the dense
    forward (exact to the last bit, any backend); "toeplitz" applies the
    normal operator as a Toeplitz-embedded FFT convolution (one precomputed
    PSF kernel, then two 2n-FFT pairs per iteration instead of a
    degrid+grid — see toeplitz_fourier_kernel; the RHS A^H W b still uses
    the fast adjoint once); "auto" resolves to "toeplitz" when
    cfg.toeplitz is set, else to "pair" on a GPU and "transpose" elsewhere.
    """
    niter = cfg.niter if niter is None else niter
    npe, nro = data.shape[-2:]
    n = nro // 2
    nxos = int(n * cfg.gridos)
    img_shape = data.shape[:-2] + (n, n)
    # readout 0 (one sample per spoke, at the highest |k|) is weighted out of
    # the least-squares problem in EVERY operator mode: the gridding kernel
    # never grids it (edge clip, reference convention), so this makes
    # pair/transpose/toeplitz all solve the identical W-weighted problem —
    # platform-independent solutions, and the Toeplitz kernel (which shares
    # the convention) stays consistent with the RHS A^H W b.
    assert spoke_axis not in reduce_axes or spoke_axis is None
    w = sdc_weights(cfg, nro, npe_total or npe).astype(data.dtype).at[0].set(0)
    if sample_mask is not None:
        w = sample_mask.astype(data.dtype)[:, None] * w

    if operators == "auto" and cfg.toeplitz:
        operators = "toeplitz"  # honor the config flag for direct callers
    toeplitz = operators == "toeplitz"
    if operators in ("auto", "toeplitz"):
        # the gridder is the (clip-convention) adjoint of the gather degrid,
        # so on a GPU the normal operator is one degrid and one Triton
        # gridding call; elsewhere the autodiff transpose of the forward
        operators = "pair" if jax.default_backend() == "gpu" else "transpose"

    if operators == "pair":
        # clip-convention forward: exact transpose of the gridding adjoint
        # everywhere except readout 0 (never gridded — reference convention),
        # which is weighted out of the problem (one sample per spoke, at the
        # highest |k|).  At gridos != 2 the default adjoint's trunc-resample
        # (`src/tron.cu:517`) snaps radii by up to nxos/nro/2 grid units — a
        # poor forward model (measured: CGNR with it recons WORSE than the
        # plain adjoint) — so the pair switches to the EXACT-LATTICE
        # adjoint (nufft_adjoint_exact), whose transpose the generalized
        # degrid kernel is at any gridos.
        from tron_jax.nufft import nufft_adjoint_exact

        fwd = partial(nufft_forward, angles=angles, cfg=cfg, nro=nro, wrap=False)

        def AHW(y):
            if nro == nxos:
                out = nufft_adjoint(w * y, angles, cfg, apply_sdc=False)
            else:
                out = nufft_adjoint_exact(w * y, angles, cfg)
            out = out * (nxos * npe)  # undo the gridder's reference scale
            if spoke_axis is not None:
                out = jax.lax.psum(out, spoke_axis)
            return out

    else:
        fwd = partial(nufft_forward, angles=angles, cfg=cfg, nro=nro)
        # derive the zero linearization point from the data so its device-
        # varyance matches the cotangents under shard_map (vma consistency)
        x0 = jnp.zeros(img_shape, dtype=data.dtype) + 0.0 * data.reshape(-1)[0]
        fwd_t = jax.linear_transpose(fwd, x0)

        def AHW(y):
            # A^H z = conj(A^T conj(z)): linear_transpose gives the
            # transpose, conjugation turns it into the adjoint.
            (out,) = fwd_t(jnp.conj(w * y))
            out = jnp.conj(out)
            if spoke_axis is not None:
                out = jax.lax.psum(out, spoke_axis)
            return out

    if toeplitz:
        mult = toeplitz_fourier_kernel(
            angles, cfg, nro, npe_total=npe_total, sample_mask=sample_mask
        )
        if spoke_axis is not None:
            # per-shard kernels sum to the global one (t is linear over
            # samples); after this the iterations are collective-free
            mult = jax.lax.psum(mult, spoke_axis)

        def normal(x):
            # E^H W E (exact-NUFFT normal operator); its fixed point differs
            # from the pair/transpose modes' A^H W A only at the NUFFT
            # approximation level (~4e-4, the method's intrinsic accuracy)
            return toeplitz_apply(x, mult)

    else:

        def normal(x):
            return AHW(fwd(x))

    b = AHW(data)

    def inner(a, bb):
        v = jnp.sum(jnp.conj(a) * bb).real
        for ax in reduce_axes:
            v = jax.lax.psum(v, ax)
        return v

    def cond(state):
        k, x, r, p, rs = state
        return (k < niter) & (rs > rtol * rtol * inner(b, b))

    def body(state):
        k, x, r, p, rs = state
        Ap = normal(p)
        alpha = rs / jnp.maximum(inner(p, Ap), 1e-30)
        x = x + alpha.astype(x.dtype) * p
        r = r - alpha.astype(r.dtype) * Ap
        rs_new = inner(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = r + beta.astype(p.dtype) * p
        return k + 1, x, r, p, rs_new

    r0 = b  # initial iterate is zero
    xinit = jnp.zeros_like(b)
    state = (jnp.array(0), xinit, r0, r0, inner(r0, r0))
    _, x, _, _, _ = jax.lax.while_loop(cond, body, state)
    return x


def cgnr_or_adjoint(data, angles, cfg: ReconConfig):
    """Dispatch like the reference driver (`src/tron.cu:753-758`)."""
    if cfg.niter > 0:
        return cgnr_radial2d(data, angles, cfg)
    return nufft_adjoint(data, angles, cfg)
