"""CLI end-to-end tests (in-process, on the CPU test platform): flag
parsing, dimension inference, .ra contract, degrid->grid roundtrip through
the file interface — the RUNME1/RUNME3 flow in miniature."""

import numpy as np
import pytest

from tron_jax.cli import build_parser, main
from tron_jax.io import ra_read, ra_query, ra_write
from tron_jax.phantom import shepp_logan


@pytest.fixture
def phantom_ra(tmp_path):
    n = 32
    img = shepp_logan(n)
    p = tmp_path / "sl.ra"
    ra_write(img.T[None, None, :, :, None].astype(np.complex64), p)
    return p, img


def test_parser_reference_flags():
    a = build_parser().parse_args(
        ["-a", "-G", "-u", "0.4", "-d", "21", "-s", "3", "-k", "2.5", "-o", "1.5",
         "-i", "4", "-B", "2048", "-T", "256", "-g", "0", "-v", "in.ra", "out.ra"]
    )
    assert a.adjoint and a.golden_angle and a.verbose
    assert a.data_undersamp == 0.4 and a.prof_slide == 21 and a.skip_angles == 3
    assert a.kernwidth == 2.5 and a.gridos == 1.5 and a.niter == 4
    assert a.infile == "in.ra" and a.outfile == "out.ra"


def test_default_outfile():
    a = build_parser().parse_args(["in.ra"])
    assert a.outfile == "img_tron.ra"  # reference default (src/tron.cu:877)


def test_forward_dim_inference(phantom_ra, tmp_path):
    p, img = phantom_ra
    out = tmp_path / "data.ra"
    assert main([str(p), str(out)]) == 0
    h = ra_query(out)
    # forward: nro = gridos*nx, npe1 = undersamp*nro (src/tron.cu:936-961)
    assert h.dims == (1, 1, 64, 64, 1)
    assert h.eltype == 4 and h.elbyte == 8


def test_roundtrip_through_files(phantom_ra, tmp_path):
    p, img = phantom_ra
    data = tmp_path / "data.ra"
    rec = tmp_path / "img.ra"
    assert main([str(p), str(data)]) == 0
    assert main(["-a", "--scheme", "linear_half", str(data), str(rec)]) == 0
    h = ra_query(rec)
    assert h.dims == (1, 1, 32, 32, 1)
    m = np.abs(ra_read(rec)[0, 0, :, :, 0])
    ref = np.abs(img.T)
    a = m.ravel() - m.mean()
    b = ref.ravel() - ref.mean()
    corr = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert corr > 0.85, f"file roundtrip correlation {corr:.3f}"


def test_adjoint_sliding_window_dims(tmp_path, rng):
    nc, nro, npe1 = 2, 32, 48
    d = (rng.standard_normal((nc, 1, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, 1, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "d.ra"
    ra_write(d, p)
    out = tmp_path / "o.ra"
    # -u 0.5 -> work=16, -d 8 -> nz = 1+(48-16)/8 = 5
    assert main(["-a", "-G", "-u", "0.5", "-d", "8", str(p), str(out)]) == 0
    assert ra_query(out).dims == (1, 1, 16, 16, 5)


def test_bad_input_rank(tmp_path, rng):
    p = tmp_path / "bad.ra"
    ra_write(rng.standard_normal((4, 4)).astype(np.complex64), p)
    assert main([str(p), str(tmp_path / "o.ra")]) == 1


@pytest.mark.parametrize("device", [8, 99])
def test_device_index_with_no_device(phantom_ra, tmp_path, capsys, device):
    """-g naming no device is an error (exit 1), not silently device 0."""
    p, _ = phantom_ra
    out = tmp_path / "o.ra"
    assert main(["-g", str(device), str(p), str(out)]) == 1
    assert "error: -g" in capsys.readouterr().err
    assert not out.exists()
