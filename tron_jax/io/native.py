"""ctypes binding to the native C++ RawArray library (tron_jax/_native).

The native module is the runtime-native parity component for the reference's
ra.cu / float16.cu; it is built on demand with `make` (g++) and falls back
transparently to the pure-Python implementation if unavailable.  Use
``ensure_native()`` to build/load explicitly; ``available()`` to test.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from tron_jax.io import ra as _py

_DIR = Path(__file__).resolve().parent.parent / "_native"
_LIB_PATH = _DIR / "libra_native.so"
_lib = None


class _RaNat(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_uint64),
        ("eltype", ctypes.c_uint64),
        ("elbyte", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
        ("ndims", ctypes.c_uint64),
        ("dims", ctypes.POINTER(ctypes.c_uint64)),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
    ]


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "-C", str(_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def ensure_native() -> bool:
    """Load (building if needed) the native library; returns availability."""
    global _lib
    if _lib is not None:
        return True
    if not _LIB_PATH.exists() and not _build():
        return False
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return False
    lib.ra_nat_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_RaNat)]
    lib.ra_nat_query.argtypes = [ctypes.c_char_p, ctypes.POINTER(_RaNat)]
    lib.ra_nat_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(_RaNat)]
    lib.ra_nat_free.argtypes = [ctypes.POINTER(_RaNat)]
    lib.f32_to_f16.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_size_t,
    ]
    lib.f16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_size_t,
    ]
    _lib = lib
    return True


def available() -> bool:
    return ensure_native()


_ERRORS = {
    -1: "I/O error",
    -2: "bad magic",
    -3: "unsupported flags",
    -4: "alloc failed",
    -5: "region out of range",
}


def _check(rc: int, path):
    if rc != 0:
        raise IOError(f"ra_native: {_ERRORS.get(rc, rc)} for {path}")


def ra_read(path, order: str = "F") -> np.ndarray:
    if not ensure_native():
        return _py.ra_read(path, order=order)
    a = _RaNat()
    rc = _lib.ra_nat_read(os.fspath(path).encode(), ctypes.byref(a))
    if rc == -3:
        # flags the native layer refuses (big-endian byte-swap lives in the
        # Python reader; compressed raises there with a clear message)
        return _py.ra_read(path, order=order)
    _check(rc, path)
    try:
        dims = tuple(a.dims[i] for i in range(a.ndims))
        dtype = _py.eltype_to_dtype(int(a.eltype), int(a.elbyte))
        buf = ctypes.string_at(a.data, a.size)
    finally:
        _lib.ra_nat_free(ctypes.byref(a))
    arr = np.frombuffer(buf, dtype=dtype).reshape(dims[::-1])
    return arr.T if order == "F" else arr


def ra_write(arr: np.ndarray, path, dims=None) -> None:
    if not ensure_native():
        return _py.ra_write(arr, path, dims=dims)
    arr = np.asarray(arr)
    eltype, elbyte = _py.dtype_to_eltype(arr.dtype)
    if dims is None:
        dims = arr.shape
    payload = np.asfortranarray(arr).reshape(-1, order="F")
    payload = np.ascontiguousarray(payload)
    dims_arr = (ctypes.c_uint64 * len(dims))(*dims)
    a = _RaNat(
        flags=0,
        eltype=eltype,
        elbyte=elbyte,
        size=payload.nbytes,
        ndims=len(dims),
        dims=dims_arr,
        data=ctypes.cast(payload.ctypes.data, ctypes.POINTER(ctypes.c_uint8)),
    )
    _check(_lib.ra_nat_write(os.fspath(path).encode(), ctypes.byref(a)), path)


def f32_to_f16(x: np.ndarray) -> np.ndarray:
    """Bit-exact float32 -> float16 via the native converter."""
    if not ensure_native():
        return np.asarray(x, np.float32).astype(np.float16)
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint16)
    _lib.f32_to_f16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        x.size,
    )
    return out.view(np.float16)


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    if not ensure_native():
        return np.asarray(x, np.float16).astype(np.float32)
    x = np.ascontiguousarray(x, dtype=np.float16).view(np.uint16)
    out = np.empty(x.shape, dtype=np.float32)
    _lib.f16_to_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
    )
    return out


def radial_dims(hdr) -> tuple[int, int, int, int, int, bool]:
    """(nc, nt, nro, npe1, npe2, pair) of a radial .ra header.

    ``pair`` marks the float re/im-pair storage convention (a leading dim
    of 2, the raread.m trick used by ``--half`` outputs,
    `src/raread.m:25-57`); plain 5-D files (complex or float) have
    pair=False."""
    dims = [int(d) for d in hdr.dims]
    pair = (
        len(dims) >= 6
        and dims[0] == 2
        and not np.issubdtype(hdr.dtype, np.complexfloating)
    )
    base = dims[1:] if pair else dims
    if len(base) < 4:
        raise ValueError(f"expected a 5-D radial .ra, got dims {dims}")
    npe2 = base[4] if len(base) > 4 else 1
    return base[0], base[1], base[2], base[3], npe2, pair


def ra_read_profiles(path, pe0: int, npe: int) -> np.ndarray:
    """Stream a profile window from a radial .ra file without loading the
    whole acquisition: returns complex (nc, nt, nro, npe) for profiles
    [pe0, pe0+npe) — the windowed loader behind sliding-window recon of
    very large files (the reference's per-frame H2D window copies,
    src/tron.cu:738-748, as a native seek+read).

    Handles complex files, plain float files (promoted), and the float
    re/im-pair convention of ``--half`` outputs (6-D with a leading dim of
    2; the pair stride is accounted for in the per-profile seek).
    """
    hdr = _py.ra_query(path)
    out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe)
    return _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)


def _read_profile_window(path, hdr, pe0: int, npe: int, pe2: int = 0):
    """Raw window read of profiles [pe0, pe0+npe) of kz-slice ``pe2``:
    returns (flat elements, nc, nt, nro, pair).  One contiguous region per
    call — profiles are the second-slowest on-disk axis (npe2 slowest)."""
    nc, nt, nro, npe1, _, pair = radial_dims(hdr)
    unit = 2 if pair else 1
    dtype = hdr.dtype
    per = unit * nc * nt * nro                     # elements per profile
    stride = per * dtype.itemsize                  # bytes per profile
    offset = (pe2 * npe1 + pe0) * stride
    count = npe * stride
    out = np.empty(npe * per, dtype=dtype)
    if ensure_native():
        _lib.ra_nat_read_region.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        rc = _lib.ra_nat_read_region(
            os.fspath(path).encode(), offset, count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        _check(rc, path)
    else:
        with open(path, "rb") as f:
            f.seek(hdr.data_offset + offset)
            buf = f.read(count)
        out = np.frombuffer(buf, dtype=dtype).copy()
    return out, nc, nt, nro, pair


def _decode_profile_window(out, npe, nc, nt, nro, pair, dtype):
    if pair:
        # on-disk order: re/im fastest, then nc, nt, nro, npe
        w = out.reshape(npe, nro, nt, nc, 2).astype(np.float32)
        cplx = (w[..., 0] + 1j * w[..., 1]).astype(np.complex64)
        return cplx.transpose(3, 2, 1, 0)
    # on-disk order within a profile: nc fastest, then nt, then nro
    arr = out.reshape(npe, nro, nt, nc).transpose(3, 2, 1, 0)
    if not np.issubdtype(dtype, np.complexfloating):
        arr = arr.astype(np.complex64)
    return arr


def ra_read_profiles_stack(path, pe0: int, npe: int) -> np.ndarray:
    """Stream a profile window of a 3-D stack-of-stars .ra at EVERY kz
    encoding: returns complex (nc, nt, nro, npe, npe2) for profiles
    [pe0, pe0+npe) — the windowed loader behind streamed `-3` recon.

    npe2 is the slowest on-disk axis, so this is one contiguous region
    read per kz encoding (npe2 seeks); complex, plain-float, and
    fp16-pair files all work (same decode as ra_read_profiles).
    """
    hdr = _py.ra_query(path)
    _, _, _, _, npe2, _ = radial_dims(hdr)
    stack = None
    for pe2 in range(npe2):
        out, nc, nt, nro, pair = _read_profile_window(path, hdr, pe0, npe, pe2)
        plane = _decode_profile_window(out, npe, nc, nt, nro, pair, hdr.dtype)
        if stack is None:
            # preallocate so peak host memory is window + 1 plane, not 2x
            # the window (reference-scale windows are ~630 MB)
            stack = np.empty(plane.shape + (npe2,), plane.dtype)
        stack[..., pe2] = plane
    return stack


def ra_write_region(path, byte_offset: int, buf: np.ndarray) -> bool:
    """pwrite ``buf`` into the .ra data payload at ``byte_offset`` (the file
    must already carry its header — io.ra.RaWriter writes it).  Returns
    False when the native library is unavailable so the caller can fall
    back to Python file I/O; raises on real I/O errors."""
    if not ensure_native():
        return False
    buf = np.ascontiguousarray(buf)
    _lib.ra_nat_write_region.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    rc = _lib.ra_nat_write_region(
        os.fspath(path).encode(), byte_offset, buf.nbytes,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    _check(rc, path)
    return True
