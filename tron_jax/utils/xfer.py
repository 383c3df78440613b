"""Device -> host readback in reduced precision."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("dtype",))
def _split_cast(a: jnp.ndarray, dtype):
    return jnp.real(a).astype(dtype), jnp.imag(a).astype(dtype)


def to_host_planes(a: jax.Array, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Complex device array -> (re, im) host planes cast ON DEVICE to
    ``dtype`` before the transfer.  ``dtype=float16`` halves device->host
    bytes — the readback analog of the reference's fp16 storage path
    (`src/float16.cu`), used by the ``--half`` readback."""
    re, im = _split_cast(a, jnp.dtype(dtype))
    return np.asarray(re), np.asarray(im)
