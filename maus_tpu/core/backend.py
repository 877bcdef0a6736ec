"""What the JAX backend this process runs on can do.

This is the only module that looks at ``jax.default_backend()`` to decide
behaviour. Every other module asks one of the questions below, so a new
platform, or a new fact about one, is one edit here. The supported platforms
are the CPU and NVIDIA GPUs; any other backend is refused with
:class:`UnsupportedBackendError` rather than run on a guess.

Tests inject answers by monkeypatching these functions (never by switching
JAX's backend): callers reach them as ``backend.<question>()`` through the
module, so a patched function is seen everywhere.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

SUPPORTED_PLATFORMS = ("cpu", "gpu")


class UnsupportedBackendError(RuntimeError):
    """JAX's default backend is not one this library supports."""


def platform() -> str:
    """``"cpu"`` or ``"gpu"``; raises for any other JAX backend."""
    name = jax.default_backend()
    if name not in SUPPORTED_PLATFORMS:
        raise UnsupportedBackendError(
            f"maus_tpu supports the {' and '.join(SUPPORTED_PLATFORMS)} "
            f"backends; JAX's default backend is {name!r}")
    return name


def is_accelerator() -> bool:
    """True on the GPU. Speed policies that only pay off on an accelerator
    key on this, never on the platform name."""
    return platform() != "cpu"


def native_f64() -> bool:
    """float64/complex128 arithmetic runs natively (both supported
    platforms). When False, the f64 matvecs of refinement and of the
    condition probe fall back to the exact-slicing low-precision ladders of
    :mod:`maus_tpu.ops.refine`."""
    platform()
    return True


def complex_host_transfer() -> bool:
    """Complex arrays cross the host boundary with plain ``device_put`` and
    ``np.asarray`` (both supported platforms). When False,
    :mod:`maus_tpu.utils.xfer` moves them as real planes."""
    platform()
    return True


def branch_memory_cap() -> bool:
    """The compiler caps the scratch memory of a ``lax.cond`` branch so
    tightly that a large factorization cannot be rebuilt inside the evolve
    loop, and the complex LU of a (batched) shifted system is refused past a
    few thousand rows. Neither supported platform has such a cap. When True,
    linear runs refactorize in a host-driven program
    (``SolverConfig.host_refactor``) and the eig finisher factors its shifted
    systems one at a time (``ops.refine_eig._percand_shifted_solver``)."""
    platform()
    return False


def needs_host_refactor(n: int) -> bool:
    """Whether a linear run of order ``n`` should rebuild its shared
    factorization in a host-driven program (the auto value of
    ``SolverConfig.host_refactor``): only under a branch memory cap, and
    only past 8192, the largest order at which the in-loop rebuild was
    known to compile under such a cap."""
    return branch_memory_cap() and n >= 12288


def device_memory_bytes() -> int:
    """Memory one device offers the program: the GPU allocator's limit
    (``memory_stats()["bytes_limit"]``, which follows
    ``XLA_PYTHON_CLIENT_MEM_FRACTION``), or the host's physical memory on
    the CPU. Size thresholds scale from this instead of fixed byte counts."""
    if platform() == "gpu":
        stats = jax.devices()[0].memory_stats() or {}
        if "bytes_limit" in stats:
            return int(stats["bytes_limit"])
        raise UnsupportedBackendError(
            "the GPU device reports no memory_stats()['bytes_limit']")
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def default_complex_dtype():
    """Working dtype of the evolve loop when the caller gives none:
    complex128 on the CPU with x64 enabled; complex64 on the GPU, where the
    float64 refinement closes the gap to the tolerance."""
    if platform() == "cpu" and jax.config.jax_enable_x64:
        return jnp.complex128
    return jnp.complex64
