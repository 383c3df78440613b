from tron_jax.io.ra import (
    RA_MAGIC,
    RaHeader,
    RaWriter,
    ra_read,
    ra_write,
    ra_query,
    ra_convert,
    dtype_to_eltype,
    eltype_to_dtype,
)

__all__ = [
    "RA_MAGIC",
    "RaHeader",
    "RaWriter",
    "ra_read",
    "ra_write",
    "ra_query",
    "ra_convert",
    "dtype_to_eltype",
    "eltype_to_dtype",
]
