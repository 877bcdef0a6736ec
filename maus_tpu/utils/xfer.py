"""Host↔device transfers for complex arrays.

Where the backend moves complex arrays across the host boundary
(``backend.complex_host_transfer()``, true on every supported platform) these
are plain ``jnp.asarray``/``np.asarray``. Otherwise every complex transfer
moves as separate real/imag float planes, combined/split by a tiny jitted
program on the device side.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import backend


def _needs_split() -> bool:
    return not backend.complex_host_transfer()


@functools.partial(jax.jit, static_argnames=())
def _combine(re: jax.Array, im: jax.Array) -> jax.Array:
    return jax.lax.complex(re, im)


@jax.jit
def _split(z: jax.Array) -> tuple[jax.Array, jax.Array]:
    return z.real, z.imag


def to_device_complex(x_host, dtype) -> jax.Array:
    """Move a host (possibly complex) array to the default device in ``dtype``."""
    dtype = jnp.dtype(dtype)
    x_host = np.asarray(x_host)
    if not jnp.issubdtype(dtype, jnp.complexfloating) or not _needs_split():
        return jnp.asarray(x_host, dtype)
    rdt = np.float32 if dtype == jnp.complex64 else np.float64
    re = jnp.asarray(np.ascontiguousarray(x_host.real, rdt))
    im = jnp.asarray(np.ascontiguousarray(x_host.imag, rdt))
    return _combine(re, im).astype(dtype)


@jax.jit
def _c64_from_f64_planes(re64: jax.Array, im64: jax.Array) -> jax.Array:
    return jax.lax.complex(re64.astype(jnp.float32), im64.astype(jnp.float32))


@jax.jit
def _deinterleave(packed: jax.Array) -> tuple[jax.Array, jax.Array]:
    return packed[..., 0], packed[..., 1]


def to_device_split_f64(x_host) -> tuple[jax.Array, jax.Array]:
    """Move a host complex array to device as full-precision (re, im) float64
    planes. One 2·8·size-byte transfer; callers derive the complex64 compute
    copy on device via :func:`c64_from_split_f64` so the operand crosses to
    the device exactly once.

    A C-contiguous complex128 input is transferred as its raw interleaved-f64
    view and de-interleaved on device — zero host-side plane copies (the
    strided ``.real``/``.imag`` extractions cost ~1.2 s each at 4096² on
    host)."""
    x_host = np.asarray(x_host)
    if x_host.dtype == np.complex128 and x_host.flags.c_contiguous:
        packed = jnp.asarray(x_host.view(np.float64)
                             .reshape(x_host.shape + (2,)))
        return _deinterleave(packed)
    re = jnp.asarray(np.ascontiguousarray(x_host.real, np.float64))
    im = jnp.asarray(np.ascontiguousarray(x_host.imag, np.float64))
    return re, im


def c64_from_split_f64(re64: jax.Array, im64: jax.Array) -> jax.Array:
    """complex64 compute copy of split-f64 planes (device-side rounding —
    identical to transferring astype(complex64) directly)."""
    return _c64_from_f64_planes(re64, im64)


def to_host_complex(x_dev) -> np.ndarray:
    """Read back a device array (complex-safe) as numpy."""
    if not jnp.issubdtype(x_dev.dtype, jnp.complexfloating) or not _needs_split():
        return np.asarray(x_dev)
    re, im = _split(x_dev)
    re_h = np.asarray(re)
    im_h = np.asarray(im)
    cdt = np.complex64 if re_h.dtype == np.float32 else np.complex128
    out = np.empty(re_h.shape, cdt)
    out.real = re_h
    out.imag = im_h
    return out
