from tron_jax.ops.fftops import (
    centered_fft2,
    centered_ifft2_unnormalized,
    crop_center,
    pad_center,
    deapodize,
    deapod_weights,
)
from tron_jax.ops.grid import grid_radial2d
from tron_jax.ops.degrid import degrid_radial2d
from tron_jax.ops.coil import (
    coil_combine_sos,
    coil_combine_walsh,
    coil_combine_walsh_frames,
)

__all__ = [
    "centered_fft2",
    "centered_ifft2_unnormalized",
    "crop_center",
    "pad_center",
    "deapodize",
    "deapod_weights",
    "grid_radial2d",
    "degrid_radial2d",
    "coil_combine_sos",
    "coil_combine_walsh",
    "coil_combine_walsh_frames",
]
