"""ra utility CLI tests (query/reshape/convert/diff/squash) and the CLI
fp16 / re-im-pair paths."""

import numpy as np

from tron_jax.io import ra_query, ra_read, ra_write
from tron_jax.tools.ra_tool import main as ra_main


def test_query_reshape_squash(tmp_path, rng, capsys):
    p = tmp_path / "a.ra"
    ra_write(rng.standard_normal((2, 3, 4)).astype(np.float32), p)
    assert ra_main(["query", str(p)]) == 0
    out = capsys.readouterr().out
    assert "float32" in out and "[2, 3, 4]" in out

    assert ra_main(["reshape", str(p), "6", "4"]) == 0
    assert ra_query(p).dims == (6, 4)
    assert ra_main(["reshape", str(p), "5", "5"]) == 1  # size mismatch

    ra_write(rng.standard_normal((1, 4, 1, 6)).astype(np.float32), p)
    assert ra_main(["squash", str(p)]) == 0
    assert ra_query(p).dims == (4, 6)


def test_convert_fp16(tmp_path, rng):
    p, q = tmp_path / "a.ra", tmp_path / "b.ra"
    x = rng.standard_normal((8, 8)).astype(np.float32)
    ra_write(x, p)
    assert ra_main(["convert", str(p), str(q), "--eltype", "3", "--elbyte", "2"]) == 0
    b = ra_read(q)
    assert b.dtype == np.float16
    np.testing.assert_array_equal(b, x.astype(np.float16))


def test_diff(tmp_path, rng, capsys):
    a, b = tmp_path / "a.ra", tmp_path / "b.ra"
    x = rng.standard_normal((4, 4)).astype(np.float32)
    ra_write(x, a)
    ra_write(x, b)
    assert ra_main(["diff", str(a), str(b)]) == 0
    ra_write(x + 1e-3, b)
    assert ra_main(["diff", str(a), str(b)]) == 1
    assert "nrmse" in capsys.readouterr().out


def test_cli_half_output_and_pair_input(tmp_path):
    from tron_jax.cli import main
    from tron_jax.phantom import shepp_logan

    n = 16
    img = shepp_logan(n)
    src = tmp_path / "sl.ra"
    ra_write(img.T[None, None, :, :, None].astype(np.complex64), src)

    # forward with --half -> fp16 re/im-pair output
    half = tmp_path / "d16.ra"
    assert main([str(src), str(half), "--half"]) == 0
    h = ra_query(half)
    assert h.eltype == 3 and h.elbyte == 2 and h.dims[0] == 2

    # and the pair file round-trips back through the adjoint
    rec = tmp_path / "img.ra"
    assert main(["-a", "--scheme", "linear_half", str(half), str(rec)]) == 0
    assert ra_query(rec).dims == (1, 1, n, n, 1)
    m = np.abs(ra_read(rec)[0, 0, :, :, 0])
    assert np.isfinite(m).all() and m.max() > 0


def test_half_subcommand_roundtrip(tmp_path, rng):
    """ra_tool half: complex -> fp16 re/im-pair (leading dim of 2) and back;
    the pair file must be exactly what the streaming reader and --half
    outputs use, and the back-conversion must equal an f16 quantization."""
    from tron_jax.tools.ra_tool import main as ra_main

    x = (rng.standard_normal((3, 1, 8, 5, 1)) +
         1j * rng.standard_normal((3, 1, 8, 5, 1))).astype(np.complex64)
    c = tmp_path / "c.ra"
    h = tmp_path / "h.ra"
    r = tmp_path / "r.ra"
    ra_write(x, c)
    assert ra_main(["half", str(c), str(h)]) == 0
    hq = ra_query(h)
    assert hq.eltype == 3 and hq.elbyte == 2
    assert hq.dims == (2, 3, 1, 8, 5, 1)
    assert ra_main(["half", str(h), str(r)]) == 0
    back = ra_read(r)
    assert back.dtype == np.complex64 and back.shape == x.shape
    want = (x.real.astype(np.float16).astype(np.float32)
            + 1j * x.imag.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(back, want.astype(np.complex64))

    # non-complex, non-pair input is an error
    f = tmp_path / "f.ra"
    ra_write(np.zeros((3, 3), np.float32), f)
    assert ra_main(["half", str(f), str(tmp_path / "o.ra")]) == 1
    # a 5-D plain-float file whose first dim happens to be 2 (a 2-coil
    # acquisition) is NOT the 6-D pair convention — must be rejected, not
    # silently mis-combined into complex (round-4 review finding)
    g = tmp_path / "g.ra"
    ra_write(np.zeros((2, 1, 8, 5, 1), np.float32), g)
    assert ra_main(["half", str(g), str(tmp_path / "o2.ra")]) == 1
