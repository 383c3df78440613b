"""tron_jax — trajectory-optimized radial NUFFT in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of davidssmith/TRON
(MRM 2018 doi 10.1002/mrm.27497): gridding and
degridding specialized to linear- and golden-angle radial MRI trajectories,
with Kaiser-Bessel interpolation, implicit Ram-Lak density compensation,
batched FFTs with fused deapodization, sum-of-squares / Walsh coil
combination, a working CGNR iterative mode, sliding-window dynamic-frame
reconstruction, and the RawArray (.ra) file format.

Design: the hot gridding op is a Pallas kernel for the GPU (through Triton)
that keeps the reference's race-free gather — each output tile is owned by
one program, no atomics — and runs its products on the tensor cores;
degridding is the reference's per-sample gather in plain XLA and the FFTs
are cuFFT through jnp.fft.  Frames and coils shard across a device mesh via
shard_map with psum coil reduction, and everything is jit-compatible with
static shapes.
"""

from tron_jax.config import ReconConfig
from tron_jax.nufft import nufft_adjoint, nufft_forward
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.grid import grid_radial2d
from tron_jax.recon import recon_radial2d
from tron_jax.solver import cgnr_radial2d

__version__ = "0.1.0"

# The public library surface mirrors the reference's intended FFI contract
# (extern "C" {gridradial2d, degridradial2d, recon_radial_2d} + ra I/O,
# src/tron.h:55-73) plus the operator pipelines and the working solver.
__all__ = [
    "ReconConfig",
    "nufft_adjoint",
    "nufft_forward",
    "grid_radial2d",
    "degrid_radial2d",
    "recon_radial2d",
    "cgnr_radial2d",
    "__version__",
]
