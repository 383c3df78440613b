"""Reconstruction configuration.

One frozen dataclass carries every knob of the reference CLI
(`src/tron.cu:794-874`) plus the compile-time knobs that the
reference bakes into headers (`src/tron.h:48-51`, `src/Makefile:3-6`), which
here are just fields.  Being hashable, a ReconConfig can be a static argument
to jit.
"""

from __future__ import annotations

import dataclasses
import math


class AngleScheme:
    """Spoke-angle conventions.

    The reference uses *different* linear-angle conventions in its grid and
    degrid kernels (grid: pe*2*pi/npe + pi/2 at `src/tron.cu:509`; degrid:
    pe*pi/npe at `src/tron.cu:555`) — a documented quirk.  Here the scheme is
    explicit and the same scheme is used for both directions, so forward and
    adjoint are true adjoints of each other (required for CGNR to converge).
    """

    GOLDEN = "golden"           # modang(PHI * (pe + skip)); PHI = pi/golden-ratio
    LINEAR_HALF = "linear_half"  # pe * pi / npe           (reference degrid convention)
    LINEAR_FULL = "linear_full"  # pe * 2*pi / npe + pi/2  (reference grid convention)


# Golden angle increment in radians = pi / ((1+sqrt(5))/2) ~= 111.246 deg
# (`src/tron.cu:90`, `src/RUNME4_others_grid_slcmt.m:119`).
PHI = math.pi / ((1.0 + math.sqrt(5.0)) / 2.0)


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    # Geometry / kernel (reference defaults at src/tron.cu:66-69)
    gridos: float = 2.0          # -o grid oversampling factor
    kernwidth: float = 2.0       # -k kernel half-width in oversampled grid units
    beatty: bool = False         # -DBEATTY_BETA variant of the KB shape

    # Trajectory
    golden_angle: bool = False   # -G
    skip_angles: int = 0         # -s
    angle_scheme: str | None = None  # override; default derived per direction

    # Sliding-window framing (src/tron.cu:904-935)
    data_undersamp: float = 1.0  # -u
    prof_slide: int = 0          # -d (0 -> npe1work, i.e. non-overlapping frames)

    # Pipeline
    adjoint: bool = False        # -a
    deapodize: bool = True       # on by default (src/tron.cu:87)
    sdc: str = "ramlak"          # "ramlak" (reference parity, src/tron.cu:405-416)
                                 # | "ideal" (exact polar cell areas, unit gain)
    niter: int = 0               # -i CGNR iterations (0 = plain adjoint)
    toeplitz: bool = False       # --toeplitz: apply the CGNR normal operator
                                 # as a Toeplitz-embedded FFT convolution
                                 # (one precomputed PSF kernel per frame;
                                 # each iteration is two 2n-FFT pairs
                                 # instead of a degrid+grid — see
                                 # solver.toeplitz_fourier_kernel)
    koosh: bool = False          # -3 (3D stack handling)
    incremental: bool = False    # telescoping sliding-window gridding: frame
                                 # z+1's k-space grid = frame z's grid
                                 # - (leaving spokes) + (entering spokes), one
                                 # signed 2*prof_slide-spoke gridding call per
                                 # frame instead of regridding all npe1work
                                 # spokes (the reference regrids every window
                                 # from scratch, src/tron.cu:732-757).  Valid
                                 # only for the golden-angle scheme (spoke
                                 # angle depends on the global profile index,
                                 # src/tron.cu:509) with overlapping windows;
                                 # other cases fall back to the direct path.
    coil_combine: str = "sos"    # "sos" | "walsh" | "none"
    walsh_npatch: int = 1
    coil_compress: int = 0       # SVD-compress to N virtual coils (0 = off);
                                 # the reference's open TODO at src/tron.cu:765

    # Implementation knobs
    backend: str = "auto"        # adjoint gridder: "auto" (the Triton kernel
                                 # on a GPU, the plain XLA gridder on the
                                 # CPU) | "jnp" (plain XLA) | "pallas" (the
                                 # Triton kernel); see nufft.grid_backend
    precision: str = "fast"      # Triton gridder's dot: "fast" (TF32 tensor
                                 # cores, fp32 accumulation) | "accurate"
                                 # (fp32); ops.grid_triton.DOT_PRECISION
    interpret: bool = False      # run the Pallas kernel in its interpreter
                                 # (how the CPU tests reach it)
    pe_chunk: int = 8            # spokes per scan step of the plain gridder
    frame_block: int = 1         # frames (or -3 slices, or forward image
                                 # slices) per lax.map step
    inc_block: int = 1           # frames per step of the telescoping scan
                                 # (recon.incremental_scan)

    def scheme_for(self, direction: str) -> str:
        """Angle scheme for 'forward' or 'adjoint', honoring the override.

        Defaults reproduce the reference's per-direction conventions so its
        datasets reconstruct identically; set ``angle_scheme`` to get a
        self-consistent pair (as the tests and CGNR do).
        """
        if self.golden_angle:
            return AngleScheme.GOLDEN
        if self.angle_scheme is not None:
            return self.angle_scheme
        return (
            AngleScheme.LINEAR_FULL if direction == "adjoint" else AngleScheme.LINEAR_HALF
        )

    def npe1work(self, nro: int, npe1: int) -> int:
        """Profiles per frame (`src/tron.cu:916-919`)."""
        cap = int(nro * self.data_undersamp)
        return npe1 if npe1 <= cap else cap

    def frame_geometry(self, nro: int, npe1: int) -> tuple[int, int, int]:
        """(npe1work, prof_slide, nz) for a sliding-window recon
        (`src/tron.cu:916-928`)."""
        work = self.npe1work(nro, npe1)
        slide = self.prof_slide if self.prof_slide > 0 else work
        nz = 1 + (npe1 - work) // slide
        return work, slide, nz
