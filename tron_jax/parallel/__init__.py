from tron_jax.parallel import distributed
from tron_jax.parallel.mesh import (
    make_mesh,
    recon_forward_sharded,
    recon_frames_sharded,
    recon_stack_of_stars_sharded,
)
from tron_jax.parallel.spoke import (
    make_spoke_mesh,
    nufft_adjoint_spoke_sharded,
    recon_window_spoke_sharded,
)

__all__ = [
    "make_mesh",
    "recon_forward_sharded",
    "recon_frames_sharded",
    "recon_stack_of_stars_sharded",
    "distributed",
    "make_spoke_mesh",
    "nufft_adjoint_spoke_sharded",
    "recon_window_spoke_sharded",
]
