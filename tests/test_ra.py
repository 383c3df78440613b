"""Byte-level .ra format tests (golden fixtures built by hand from the spec
at reference src/ra.h:38-72)."""

import struct

import numpy as np
import pytest

from tron_jax.io import ra_read, ra_write, ra_query, ra_convert, RA_MAGIC


def _golden_bytes():
    """Hand-assemble a tiny .ra file: complex64, dims (2, 3)."""
    data = np.arange(6, dtype=np.complex64) * (1 + 2j)
    # F-order on disk, dims[0]=2 fastest
    arr = data.reshape(3, 2).T  # shape (2, 3), F-varying first dim
    header = struct.pack(
        "<8Q", RA_MAGIC, 0, 4, 8, arr.nbytes, 2, 2, 3
    )
    return header + arr.T.tobytes(), arr  # C-bytes of (3,2) == F-bytes of (2,3)


def test_read_golden(tmp_path):
    raw, expect = _golden_bytes()
    p = tmp_path / "g.ra"
    p.write_bytes(raw)
    arr = ra_read(p)
    assert arr.shape == (2, 3)
    assert arr.dtype == np.complex64
    np.testing.assert_array_equal(arr, expect)


def test_write_matches_golden(tmp_path):
    raw, expect = _golden_bytes()
    p = tmp_path / "w.ra"
    ra_write(expect, p)
    assert p.read_bytes() == raw


def test_roundtrip_dtypes(tmp_path, rng):
    for dtype in [np.int32, np.uint16, np.float32, np.float64, np.complex64, np.float16]:
        a = rng.standard_normal((4, 5, 6)).astype(dtype)
        p = tmp_path / f"{np.dtype(dtype).name}.ra"
        ra_write(a, p)
        b = ra_read(p)
        assert b.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(a, b)


def test_query(tmp_path, rng):
    a = rng.standard_normal((1, 1, 8, 8, 1)).astype(np.complex64)
    p = tmp_path / "q.ra"
    ra_write(a, p)
    h = ra_query(p)
    assert h.dims == (1, 1, 8, 8, 1)
    assert h.eltype == 4 and h.elbyte == 8
    assert h.size == a.nbytes


def test_mmap_read(tmp_path, rng):
    a = rng.standard_normal((16, 3)).astype(np.float32)
    p = tmp_path / "m.ra"
    ra_write(a, p)
    b = ra_read(p, mmap=True)
    np.testing.assert_array_equal(a, np.asarray(b))


def test_bad_magic(tmp_path):
    p = tmp_path / "bad.ra"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        ra_read(p)


def test_unknown_flag_warns(tmp_path):
    raw, _ = _golden_bytes()
    mutated = bytearray(raw)
    mutated[8] = 0x04  # set an unknown flag bit
    p = tmp_path / "f.ra"
    p.write_bytes(bytes(mutated))
    with pytest.warns(UserWarning):
        ra_read(p)


def test_fp16_convert_bitexact():
    # numpy's half conversion is the same ties-to-even algorithm the
    # reference carries in src/float16.cu (itself lifted from numpy).
    x = np.array([0.0, 1.0, 65504.0, 1e-8, 3.14159, -2.5], dtype=np.float32)
    h = ra_convert(x, 3, 2)
    assert h.dtype == np.float16
    np.testing.assert_array_equal(h, x.astype(np.float16))


def test_dims_relabel(tmp_path, rng):
    a = rng.standard_normal(24).astype(np.float32)
    p = tmp_path / "r.ra"
    ra_write(a, p, dims=(2, 3, 4))
    b = ra_read(p)
    assert b.shape == (2, 3, 4)
    np.testing.assert_array_equal(b.ravel(order="F"), a)


def test_big_endian_read_byteswaps(tmp_path):
    """BE files warn-and-proceed (like the reference's unknown-flag path,
    src/ra.cu:98-102): data is byte-swapped to native order on read, via
    both the pure-Python reader and the native binding's fallback."""
    from tron_jax.io.ra import RA_FLAG_BIG_ENDIAN

    data = (np.arange(6, dtype=np.complex64) * (1 + 2j)).reshape(3, 2).T
    header = struct.pack(
        "<8Q", RA_MAGIC, RA_FLAG_BIG_ENDIAN, 4, 8, data.nbytes, 2, 2, 3
    )
    be = data.T.astype(np.dtype(">c8"))
    p = tmp_path / "be.ra"
    p.write_bytes(header + be.tobytes())

    with pytest.warns(UserWarning, match="big-endian"):
        arr = ra_read(p)
    assert arr.dtype.byteorder in ("=", "<", "|")
    np.testing.assert_array_equal(arr, data)

    from tron_jax.io import native

    if native.available():
        with pytest.warns(UserWarning, match="big-endian"):
            arr2 = native.ra_read(p)
        np.testing.assert_array_equal(arr2, data)


def test_ra_writer_matches_one_shot_write(tmp_path, rng):
    """RaWriter region writes (in-order, out-of-order, overlapping rewrite)
    must produce byte-identical files to ra_write."""
    from tron_jax.io import RaWriter

    a = (rng.standard_normal((4, 5, 6)) +
         1j * rng.standard_normal((4, 5, 6))).astype(np.complex64)
    p1 = tmp_path / "one.ra"
    ra_write(a, p1)
    golden = p1.read_bytes()
    fe = 4 * 5  # elements per frame (dims[-1] is the slowest/frame axis)

    def frame(z):
        # on-disk order within a frame: dims[0] fastest -> C array (d1, d0)
        return np.ascontiguousarray(a[:, :, z].T)

    p2 = tmp_path / "inorder.ra"
    with RaWriter(p2, (4, 5, 6), np.complex64) as w:
        for z in range(6):
            w.write_at(z * fe, frame(z))
    assert p2.read_bytes() == golden

    p3 = tmp_path / "shuffled.ra"
    with RaWriter(p3, (4, 5, 6), np.complex64) as w:
        for z in [3, 0, 5, 1, 4, 2, 3]:  # incl. an overlapping rewrite
            w.write_at(z * fe, frame(z))
    assert p3.read_bytes() == golden


def test_ra_writer_bounds_and_abort(tmp_path):
    from tron_jax.io import RaWriter

    p = tmp_path / "w.ra"
    w = RaWriter(p, (4, 2), np.float32)
    with pytest.raises(ValueError):
        w.write_at(6, np.zeros(4, np.float32))  # 6+4 > 8 elements
    w.abort()
    assert not p.exists() and not list(tmp_path.glob("*.tmp.*"))
