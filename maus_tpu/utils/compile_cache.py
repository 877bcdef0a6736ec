"""Persistent XLA compilation cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives in one fixed directory
inside the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the
path is part of the cache's key, so it is never built from a temporary name,
a pid or the time. The cache is enabled on the GPU only; CPU compiles are
local and fast.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

from ..core import backend

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the environment variable's value when it
    is set, else the fixed in-checkout default."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable() -> bool:
    """Enable the persistent compilation cache on the GPU (no-op on the
    CPU). Returns True when enabled; a checkout the process cannot write
    leaves the cache off rather than failing the solve."""
    if not backend.is_accelerator():
        return False
    if not os.environ.get(ENV_VAR):
        try:
            DEFAULT_DIR.mkdir(exist_ok=True)
        except OSError:
            return False
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return True


_auto_done = False


def enable_once() -> None:
    """Library-level auto-enable (MausSolver/MeshSolver construction): GPU
    compiles of the large programs take seconds to minutes, so banking them
    is almost always what the user wants. Opt out with
    ``MAUS_NO_COMPILE_CACHE=1``; a cache directory the user configured in
    code is never overridden."""
    global _auto_done
    if _auto_done:
        return
    _auto_done = True
    if os.environ.get("MAUS_NO_COMPILE_CACHE") == "1":
        return
    if jax.config.jax_compilation_cache_dir:
        return      # set by the user, in code or through the env var
    enable()
