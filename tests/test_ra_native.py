"""Native C++ .ra module: byte parity with the pure-Python oracle and
bit-exact fp16 conversion."""

import numpy as np
import pytest

from tron_jax.io import ra_read as py_read, ra_write as py_write
from tron_jax.io import native

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib unavailable")


def test_native_write_matches_python_bytes(tmp_path, rng):
    a = (rng.standard_normal((3, 4, 5)) + 1j * rng.standard_normal((3, 4, 5))).astype(
        np.complex64
    )
    p1, p2 = tmp_path / "py.ra", tmp_path / "nat.ra"
    py_write(a, p1)
    native.ra_write(a, p2)
    assert p1.read_bytes() == p2.read_bytes()


def test_native_read_roundtrip(tmp_path, rng):
    for dtype in [np.float32, np.complex64, np.int16, np.float16]:
        a = rng.standard_normal((7, 2)).astype(dtype)
        p = tmp_path / f"{np.dtype(dtype).name}.ra"
        py_write(a, p)
        b = native.ra_read(p)
        assert b.shape == a.shape and b.dtype == a.dtype
        np.testing.assert_array_equal(a, b)
        # and python can read native-written files
        p2 = tmp_path / f"{np.dtype(dtype).name}_n.ra"
        native.ra_write(a, p2)
        np.testing.assert_array_equal(py_read(p2), a)


def test_native_bad_magic(tmp_path):
    p = tmp_path / "bad.ra"
    p.write_bytes(b"\x01" * 64)
    with pytest.raises(IOError):
        native.ra_read(p)


def test_fp16_bitexact_vs_numpy(rng):
    x = np.concatenate(
        [
            rng.standard_normal(4096).astype(np.float32)
            * np.float32(10.0) ** rng.integers(-8, 6, 4096).astype(np.float32),
            np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0, 65520.0, 2**-24, 2**-25],
                     dtype=np.float32),
        ]
    )
    got = native.f32_to_f16(x)
    with np.errstate(over="ignore"):  # 65520.0 -> inf is the point of the test
        want = x.astype(np.float16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    back = native.f16_to_f32(want)
    np.testing.assert_array_equal(back, want.astype(np.float32))


def test_read_profiles_window(tmp_path, rng):
    """Windowed streaming read matches slicing the fully-loaded array."""
    nc, nt, nro, npe1 = 3, 1, 8, 20
    a = (rng.standard_normal((nc, nt, nro, npe1, 1)) +
         1j * rng.standard_normal((nc, nt, nro, npe1, 1))).astype(np.complex64)
    p = tmp_path / "w.ra"
    py_write(a, p)
    win = native.ra_read_profiles(p, 5, 7)
    assert win.shape == (nc, nt, nro, 7)
    np.testing.assert_array_equal(win, a[:, :, :, 5:12, 0])


def test_read_profiles_out_of_range(tmp_path, rng):
    a = rng.standard_normal((2, 1, 4, 6, 1)).astype(np.complex64)
    p = tmp_path / "o.ra"
    py_write(a, p)
    with pytest.raises(IOError):
        native.ra_read_profiles(p, 4, 10)


def test_native_write_region_roundtrip(tmp_path, rng):
    """ra_nat_write_region pwrites into the payload of a header-carrying
    file; region reads must see exactly the written bytes."""
    from tron_jax.io import RaWriter, ra_read

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    a = rng.standard_normal((8, 3)).astype(np.float32)
    p = tmp_path / "r.ra"
    with RaWriter(p, (8, 3), np.float32) as w:
        assert w._native is None
        for z in range(3):
            w.write_at(z * 8, a[:, z])
        assert w._native is not False  # the native pwrite path was used
    np.testing.assert_array_equal(ra_read(p), a)

    # out-of-range region must be refused by the native layer
    import pytest

    from tron_jax.io.native import ra_write_region

    with pytest.raises(IOError):
        ra_write_region(p, 8 * 3 * 4 - 2, np.zeros(4, np.float32))


def test_read_profiles_pair_and_float(tmp_path, rng):
    """The stride-aware windowed reader handles float16 re/im-pair files
    (--half convention) and plain float files, returning complex64."""
    from tron_jax.io import ra_write

    b = (rng.standard_normal((3, 1, 8, 10)) +
         1j * rng.standard_normal((3, 1, 8, 10))).astype(np.complex64)
    pair = np.stack([b.real, b.imag]).astype(np.float16)
    p = tmp_path / "pair.ra"
    ra_write(pair.reshape(2, 3, 1, 8, 10, 1), p)
    win = native.ra_read_profiles(p, 2, 5)
    assert win.dtype == np.complex64 and win.shape == (3, 1, 8, 5)
    want = (b[..., 2:7].real.astype(np.float16).astype(np.float32)
            + 1j * b[..., 2:7].imag.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(win, want.astype(np.complex64))

    f = rng.standard_normal((3, 1, 8, 10)).astype(np.float32)
    pf = tmp_path / "float.ra"
    ra_write(f.reshape(3, 1, 8, 10, 1), pf)
    win = native.ra_read_profiles(pf, 1, 4)
    np.testing.assert_array_equal(win, f[..., 1:5].astype(np.complex64))
