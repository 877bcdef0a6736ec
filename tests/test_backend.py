"""The backend-capability module and every dispatch site that asks it.

The platform answer is injected into ``maus_tpu.core.backend`` (its functions
are monkeypatched); JAX's backend itself stays the CPU. Each test pins that,
when the module answers ``"gpu"``, a site takes its native or unconstrained
branch.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from maus_tpu.core import backend
from maus_tpu.ops.refine import SplitComplex

GIB = 1 << 30


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the capability module answer for an 80 GB GPU (60 GB JAX pool)."""
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(backend, "device_memory_bytes", lambda: 60 * GIB)


def _sc(z):
    return SplitComplex(jnp.asarray(z.real, jnp.float64),
                        jnp.asarray(z.imag, jnp.float64))


# ---------------------------------------------------------------------------
# the module's own answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,accel", [("cpu", False), ("gpu", True)])
def test_answers_per_platform(monkeypatch, name, accel):
    monkeypatch.setattr(backend, "platform", lambda: name)
    assert backend.is_accelerator() is accel
    assert backend.native_f64()
    assert backend.complex_host_transfer()
    assert not backend.branch_memory_cap()
    assert not backend.needs_host_refactor(16384)


@pytest.mark.parametrize("name,dtype", [("cpu", jnp.complex128),
                                        ("gpu", jnp.complex64)])
def test_default_complex_dtype(monkeypatch, name, dtype):
    # x64 is on in this suite: c128 on the CPU, c64 + f64 refinement on GPU
    monkeypatch.setattr(backend, "platform", lambda: name)
    assert backend.default_complex_dtype() == dtype


@pytest.mark.parametrize("name", ["tpu", "rocm"])
def test_unknown_platform_raises(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    with pytest.raises(backend.UnsupportedBackendError, match=name):
        backend.platform()
    with pytest.raises(backend.UnsupportedBackendError):
        backend.native_f64()


def test_platform_is_cpu_here():
    assert backend.platform() == "cpu"


def test_device_memory_reads_gpu_bytes_limit(monkeypatch):
    dev = types.SimpleNamespace(
        memory_stats=lambda: {"bytes_limit": 61 * GIB, "bytes_in_use": 0})
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(backend.jax, "devices", lambda: [dev])
    assert backend.device_memory_bytes() == 61 * GIB


def test_device_memory_cpu_is_host_memory():
    assert backend.device_memory_bytes() > GIB


def test_host_refactor_only_under_branch_cap(monkeypatch):
    monkeypatch.setattr(backend, "branch_memory_cap", lambda: True)
    assert not backend.needs_host_refactor(8192)
    assert backend.needs_host_refactor(12288)


# ---------------------------------------------------------------------------
# dispatch sites
# ---------------------------------------------------------------------------

def test_make_true_resid_native_on_gpu(on_gpu, monkeypatch):
    """The true residual is the native 3M f64 GEMV: no ladder is built."""
    from maus_tpu.ops import refine

    def no_ladder(*a, **k):
        raise AssertionError("exact-slicing ladder built on a native-f64 "
                             "backend")

    monkeypatch.setattr(refine, "slice_split_matrix", no_ladder)
    monkeypatch.setattr(refine, "_sliced_residual_streamed", no_ladder)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    x = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    b = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    r = refine.make_true_resid(_sc(A), _sc(b))(_sc(x))
    Asum = _sc(A).re + _sc(A).im
    r3 = refine._residual_3m(_sc(A), Asum, _sc(x), _sc(b))
    np.testing.assert_array_equal(np.asarray(r.re), np.asarray(r3.re))
    np.testing.assert_array_equal(np.asarray(r.im), np.asarray(r3.im))


def test_refine_split_c64exact_native_on_gpu(on_gpu, monkeypatch):
    """refine_split_c64exact refines a c64-exact operand through the native
    residual when the module answers gpu (the kernel branch is gone)."""
    from maus_tpu.ops import refine
    from maus_tpu.ops.batched_solve import factor_qr

    def no_ladder(*a, **k):
        raise AssertionError("ladder built")

    monkeypatch.setattr(refine, "slice_split_matrix", no_ladder)
    rng = np.random.default_rng(3)
    n = 72                                 # a shape no other test traces
    Ac = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
          / np.sqrt(n)).astype(np.complex64)
    b = Ac.astype(np.complex128) @ (rng.standard_normal(n)
                                    + 1j * rng.standard_normal(n))
    fac = factor_qr(jnp.asarray(Ac))
    x0 = jnp.linalg.solve(jnp.asarray(Ac), jnp.asarray(b.astype(np.complex64)))
    refine.refine_split.clear_cache()
    xs, rel = refine.refine_split_c64exact(jnp.asarray(Ac), fac, _sc(b), x0,
                                           steps=20, tol=1e-13)
    refine.refine_split.clear_cache()
    assert float(rel) < 1e-12
    x = np.asarray(xs.re) + 1j * np.asarray(xs.im)
    assert np.linalg.norm(Ac.astype(np.complex128) @ x - b) \
        / np.linalg.norm(b) < 1e-12


@pytest.mark.parametrize("n", [64, 16384])
def test_sliced_gates_closed_on_gpu(on_gpu, n):
    from maus_tpu.ops.refine import use_sliced_matvecs, use_streamed_sliced

    z = jax.ShapeDtypeStruct((n, n), jnp.float64)
    A64 = SplitComplex(z, z)
    assert not use_sliced_matvecs(A64)
    assert not use_streamed_sliced(A64)


@pytest.mark.parametrize("n,resident", [(4096, True), (16384, False)])
def test_sliced_gates_without_native_f64(on_gpu, monkeypatch, n, resident):
    """Where f64 is not native the gates pick the resident ladder while it
    fits a share of device memory, the streamed one past it."""
    from maus_tpu.ops.refine import use_sliced_matvecs, use_streamed_sliced

    monkeypatch.setattr(backend, "native_f64", lambda: False)
    monkeypatch.setattr(backend, "device_memory_bytes", lambda: 16 * GIB)
    z = jax.ShapeDtypeStruct((n, n), jnp.float64)
    A64 = SplitComplex(z, z)
    assert use_sliced_matvecs(A64) is resident
    assert use_streamed_sliced(A64) is (not resident)


@pytest.mark.parametrize("capped", [False, True])
def test_mausolver_host_refactor_auto(on_gpu, monkeypatch, capped):
    import maus_tpu
    from maus_tpu.core.types import ProblemType
    from maus_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_once", lambda: None)
    monkeypatch.setattr(backend, "needs_host_refactor", lambda n: capped)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((16, 16)) + 16 * np.eye(16)
    b = rng.standard_normal(16)
    s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                            initial_num_candidates=4)
    assert s.config.host_refactor is capped
    assert s.config.dtype == jnp.complex64        # gpu default working dtype


def test_c64_linear_solve_at_kappa_1e6(on_gpu, monkeypatch):
    """The GPU default (c64 evolve + f64 refinement) on a κ = 1e6 operand
    through the public API returns a refined solution: the c64 convergence
    floor tracks 2·κ·ε_f32 instead of sitting below it."""
    import maus_tpu
    from bench import _device_problem
    from maus_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_once", lambda: None)
    A, b = _device_problem(192, 1e6, jnp.complex64)
    rep = maus_tpu.solve(A, b, tol=1e-8, num_candidates=8)
    assert rep.converged
    A_h = np.asarray(A).astype(np.complex128)
    b_h = np.asarray(b).astype(np.complex128)
    x = rep.best()[0]
    assert np.linalg.norm(A_h @ x - b_h) / np.linalg.norm(b_h) <= 1e-8


def test_percand_solver_vmap_lu_on_gpu(on_gpu, monkeypatch):
    """No branch memory cap: the batched vmap-LU regime at every N."""
    from maus_tpu.ops import refine_eig as re_mod

    calls = []
    real_map = jax.lax.map

    def counting_map(f, xs):
        calls.append("map")
        return real_map(f, xs)

    monkeypatch.setattr(re_mod.jax.lax, "map", counting_map)
    rng = np.random.default_rng(0)
    H = rng.standard_normal((8, 8)) + 8 * np.eye(8)
    shifts = jnp.arange(3.0)
    solve = re_mod._percand_shifted_solver(
        lambda s: jnp.asarray(H) + s * jnp.eye(8), shifts, 8192)
    assert calls == []
    B = jnp.asarray(rng.standard_normal((3, 8)))
    X = np.asarray(solve(B))
    for k in range(3):
        ref = np.linalg.solve(H + float(shifts[k]) * np.eye(8),
                              np.asarray(B[k]))
        np.testing.assert_allclose(X[k], ref, rtol=1e-10)


def test_refine_chunk_not_halved_on_gpu(on_gpu, monkeypatch):
    import dataclasses

    import maus_tpu
    from maus_tpu.core.types import ProblemType
    from maus_tpu.problems import generators as gen
    from maus_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_once", lambda: None)
    A, b = gen.well_conditioned_system(16, seed=0)
    s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                            initial_num_candidates=4)
    s.knowledge = dataclasses.replace(s.knowledge, shape=(8192, 8192))
    budget = int(maus_tpu.MausSolver._REFINE_CHUNK_SHARE * 60 * GIB)
    expect = min(8, budget // (8192 * 8192 * 8))     # c64 on gpu
    assert s._refine_chunk() == expect


def test_xfer_plain_transfer_on_gpu(on_gpu, monkeypatch):
    from maus_tpu.utils import xfer

    def no_split(*a):
        raise AssertionError("plane split used where complex transfers work")

    monkeypatch.setattr(xfer, "_combine", no_split)
    monkeypatch.setattr(xfer, "_split", no_split)
    z = (np.arange(12.0) + 1j * np.arange(12.0)[::-1]).reshape(3, 4)
    zd = xfer.to_device_complex(z, jnp.complex64)
    assert zd.dtype == jnp.complex64
    np.testing.assert_array_equal(xfer.to_host_complex(zd),
                                  z.astype(np.complex64))


@pytest.mark.parametrize("native,expect", [(True, False), (False, True)])
def test_cond_probe_c64_residuals_only_without_native_f64(
        on_gpu, monkeypatch, native, expect):
    from maus_tpu.solver import diagnose

    monkeypatch.setattr(backend, "native_f64", lambda: native)
    assert diagnose._c64_cond_residuals(16384) is expect
    assert not diagnose._c64_cond_residuals(4096)


@pytest.mark.parametrize("name,n,mem_gib,expect", [
    ("gpu", 4096, 60, True),          # R⁻¹ fits beside the working set
    ("gpu", 32768, 60, False),        # 16 N² c64 buffers exceed memory
    ("gpu", 512, 60, False),          # below the triangular-solve floor
    ("cpu", 4096, 60, False),         # CPU triangular solves at bandwidth
])
def test_want_rinv_scales_with_memory(monkeypatch, name, n, mem_gib, expect):
    from maus_tpu.ops.batched_solve import _want_rinv

    monkeypatch.setattr(backend, "platform", lambda: name)
    monkeypatch.setattr(backend, "device_memory_bytes", lambda: mem_gib * GIB)
    H = jax.ShapeDtypeStruct((n, n), jnp.complex64)
    assert _want_rinv(H) is expect


def test_hess_solve_budgets_scale_with_memory(monkeypatch):
    from maus_tpu.ops import hessenberg as hz

    monkeypatch.setattr(backend, "device_memory_bytes", lambda: 60 * GIB)
    cap, chunk = hz._hess_solve_budgets()
    # the N=4096, K=32 c64 eig sweep (8 GiB of temps) runs as one batch
    assert 32 * 2 * 4096 * 4096 * 8 <= cap
    assert 0 < chunk < cap


# ---------------------------------------------------------------------------
# the native residual against a numpy c128 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ascale,xscale", [(1.0, 1.0), (1e-3, 1e6),
                                           (1e8, 1e-8)])
def test_native_residual_matches_numpy_c128(ascale, xscale):
    """Tolerance: |fl(Ax) − Ax| ≤ γ_N·|A||x| elementwise for either side; the
    3M form adds one more such term and the two sides sum in different
    orders, so |Δr|∞ ≤ 8·N·ε₆₄·‖A‖∞·‖x‖∞ (the bound chip_smoke.py checks on
    the card)."""
    from maus_tpu.ops.refine import make_true_resid

    rng = np.random.default_rng(4)
    n = 96
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) * ascale
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * xscale
    b = A @ x * (1 + 1e-13)
    r = jax.jit(lambda a, xx, bb: make_true_resid(a, bb)(xx))(
        _sc(A), _sc(x), _sc(b))
    r = np.asarray(r.re) + 1j * np.asarray(r.im)
    bound = 8 * n * np.finfo(np.float64).eps \
        * np.abs(A).sum(axis=1).max() * np.abs(x).max()
    assert np.max(np.abs(r - (b - A @ x))) <= bound


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

def test_compile_cache_default_is_in_checkout(monkeypatch):
    from pathlib import Path

    from maus_tpu.utils import compile_cache

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    repo = Path(__file__).resolve().parents[1]
    assert Path(compile_cache.cache_dir()) == repo / ".jax_cache"


def test_compile_cache_env_var_honoured(on_gpu, monkeypatch, tmp_path):
    from maus_tpu.utils import compile_cache

    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: updates.append(a))
    assert compile_cache.cache_dir() == str(tmp_path / "cc")
    assert compile_cache.enable()
    assert updates == []                  # JAX reads the variable itself


def test_compile_cache_enable_sets_fixed_dir(on_gpu, monkeypatch, tmp_path):
    from maus_tpu.utils import compile_cache

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", tmp_path / ".jax_cache")
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: updates.append(a))
    assert compile_cache.enable()
    assert updates == [("jax_compilation_cache_dir",
                        str(tmp_path / ".jax_cache"))]
    assert (tmp_path / ".jax_cache").is_dir()


def test_compile_cache_off_on_cpu(monkeypatch):
    from maus_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: updates.append(a))
    assert not compile_cache.enable()
    assert updates == []


def test_mesh_c64_solve_refines_to_tol(monkeypatch):
    """solve(mesh=) in the GPU's working dtype (c64 factors, f64 planes) at
    κ = 1e6 meets 1e-8: each refinement step contracts only by ~κ·ε_f32, so
    the mesh path's step budget must cover more than a handful of steps."""
    import maus_tpu
    from bench import _device_problem
    from maus_tpu.parallel.mesh import make_mesh

    monkeypatch.setattr(backend, "default_complex_dtype",
                        lambda: jnp.complex64)
    A, b = _device_problem(256, 1e6, jnp.complex64)
    A_h, b_h = np.asarray(A), np.asarray(b)
    mesh = make_mesh(replica=1, model=4, devices=jax.devices()[:4])
    rep = maus_tpu.solve(A_h, b_h, tol=1e-8, num_candidates=8, mesh=mesh)
    x = rep.solutions[0][0]
    A128, b128 = A_h.astype(np.complex128), b_h.astype(np.complex128)
    assert np.linalg.norm(A128 @ x - b128) / np.linalg.norm(b128) <= 1e-8
