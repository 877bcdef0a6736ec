"""Test harness.

Default tier: CPU backend with 8 virtual devices (fast compiles, multi-device
sharding tests without accelerator hardware — SURVEY.md §4) and x64 enabled
so complex128 oracle comparisons are exact. The switch goes through
``jax.config``, before any backend is touched.

GPU tier: ``MAUS_GPU_TESTS=1 python -m pytest -m gpu tests/test_gpu.py`` keeps
the GPU backend and runs the hardware-marked tests (c64 numerics with f64
refinement, the native c128 residual, checkpoint round-trip on the card).
x64 stays ON for the split-f64 refinement.
"""
import os

import jax
import pytest

if os.environ.get("MAUS_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The full suite compiles many hundreds of distinct XLA CPU programs; with
    all of them kept loaded, jaxlib 0.9.0's CPU client segfaults inside
    ``backend_compile_and_load`` partway through the run (reproduced
    deterministically at the same test, while every module passes in
    isolation — accumulation, not any single program). Cross-module cache
    reuse is near zero (each module drives its own shapes), so this costs
    little and keeps the one-process ``pytest tests/`` run stable."""
    yield
    jax.clear_caches()
