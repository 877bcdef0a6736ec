"""Device-resident operand staging (round 3).

A `jax.Array` operand (e.g. produced by an upstream JAX pipeline) must be
consumable without ANY host round-trip: a large operand's copy through host
memory would dominate construction. These tests force the
device-staging gate on the CPU backend (where every op also works) and check
the full pipeline: staging, device diagnosis, solve/eig/svd, refinement.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import maus_tpu
from maus_tpu.core.types import ProblemType
from maus_tpu.solver import api as api_mod
from maus_tpu.solver import diagnose as diag_mod


@pytest.fixture
def force_device_staging(monkeypatch):
    monkeypatch.setattr(api_mod, "_device_staging_ok", lambda: True)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_device_solve_end_to_end(force_device_staging):
    rng = _rng(1)
    n = 64
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n)).astype(np.complex64)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = (A.astype(np.complex128) @ x_true).astype(np.complex64)
    A_dev, b_dev = jnp.asarray(A), jnp.asarray(b)
    s = api_mod.MausSolver(A_dev, ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=b_dev, initial_num_candidates=8,
                           global_convergence_tol=1e-8)
    assert s.A_host is None and s.b_host is None
    rep = s.evolve(60)
    assert rep.num_distinct >= 1
    assert rep.residuals[0] < 1e-8
    x = rep.solutions[0][0]
    r = np.linalg.norm(A.astype(np.complex128) @ x - b.astype(np.complex128))
    assert r / np.linalg.norm(b) < 1e-7


def test_device_diagnose_hermitian_and_cond(force_device_staging):
    rng = _rng(2)
    n = 96
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Ah = ((G + G.conj().T) / 2 + 3 * n * np.eye(n)).astype(np.complex64)
    kn = diag_mod.diagnose(None, ProblemType.EIGENVALUE,
                           device_operand=jnp.asarray(Ah), device_exact=True)
    assert kn.is_hermitian
    assert kn.is_positive_definite
    assert np.isfinite(kn.cond_estimate)


def test_device_eig(force_device_staging):
    rng = _rng(3)
    n = 24
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Ah = ((G + G.conj().T) / 2).astype(np.complex64)
    rep = maus_tpu.eig(jnp.asarray(Ah), tol=1e-6, num_candidates=16,
                       max_iterations=80)
    assert rep.num_distinct >= 4
    for lam, v in rep.solutions[:3]:
        r = np.linalg.norm(Ah.astype(np.complex128) @ v - lam * v)
        assert r < 1e-5 * np.linalg.norm(Ah)


def test_device_svd_rectangular(force_device_staging):
    rng = _rng(4)
    m, n = 12, 8
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.zeros((m, n))
    for i, sv in enumerate([5.0, 2.5]):
        s[i, i] = sv
    A = (U @ s @ V.T).astype(np.complex64)
    kn = diag_mod.diagnose(None, ProblemType.SVD,
                           device_operand=jnp.asarray(A), device_exact=True)
    assert kn.shape == (m, n)
    assert kn.effective_rank == 2
    rep = maus_tpu.svd(jnp.asarray(A), tol=1e-5, num_candidates=12,
                       max_iterations=100)
    assert rep.num_distinct >= 2
    sigs = sorted((t[0] for t in rep.solutions), reverse=True)
    assert abs(sigs[0] - 5.0) < 1e-2


def test_device_f64_real_input_prefetches_planes(force_device_staging):
    rng = _rng(5)
    n = 48
    A = rng.standard_normal((n, n)) / np.sqrt(n) + np.eye(n)
    b = rng.standard_normal(n)
    s = api_mod.MausSolver(jnp.asarray(A, jnp.float64),
                           ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=jnp.asarray(b.astype(np.complex128)
                                                .astype(np.complex64)))
    assert s.A_host is None
    # the f64 plane was prefetched as the refinement operand
    assert s._A64_cache is not None
    np.testing.assert_allclose(np.asarray(s._A64_cache.re), A)
    rep = s.evolve(50)
    assert rep.residuals[0] < 1e-8


def test_device_update_problem(force_device_staging):
    rng = _rng(6)
    n = 32
    A1 = (np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(np.complex64)
    A2 = (2 * np.eye(n) + 0.1 * rng.standard_normal((n, n))).astype(
        np.complex64)
    b = (rng.standard_normal(n) + 0j).astype(np.complex64)
    s = api_mod.MausSolver(jnp.asarray(A1), ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=jnp.asarray(b))
    rep1 = s.evolve(40)
    s.update_problem(matrix=jnp.asarray(A2), b_vector=jnp.asarray(b))
    assert s.A_host is None
    rep2 = s.evolve(40)
    assert rep2.residuals[0] < 1e-8
    x2 = rep2.solutions[0][0]
    r = np.linalg.norm(A2.astype(np.complex128) @ x2 - b.astype(np.complex128))
    assert r / np.linalg.norm(b) < 1e-7


def test_device_wide_rhs_certified_against_user_b(force_device_staging):
    """A float64/complex128 device rhs must be certified against ITS values,
    not their working-dtype rounding (code-review r3 finding #1)."""
    rng = _rng(9)
    n = 64
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         / np.sqrt(n) + 2 * np.eye(n)).astype(np.complex64)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b128 = A.astype(np.complex128) @ x_true          # full-precision rhs
    s = api_mod.MausSolver(jnp.asarray(A), ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=jnp.asarray(b128),
                           initial_num_candidates=8,
                           global_convergence_tol=1e-12)
    assert s._b64_dev is not None                    # wide planes kept
    rep = s.evolve(60)
    x = rep.solutions[0][0]
    # residual against the USER's b — reachable only if refinement targeted
    # the unrounded rhs (c64 rounding of b floors at ~1e-8 relative)
    r = np.linalg.norm(A.astype(np.complex128) @ x - b128) \
        / np.linalg.norm(b128)
    assert r < 1e-12
    assert rep.residuals[0] < 1e-12


def test_device_c128_operand_prefetches_planes(force_device_staging):
    """A complex128 device operand keeps full-precision planes for refinement
    (code-review r3 finding #3)."""
    rng = _rng(10)
    n = 48
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n) + 2 * np.eye(n)
    b = A @ (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    s = api_mod.MausSolver(jnp.asarray(A, jnp.complex128),
                           ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=jnp.asarray(b),
                           initial_num_candidates=8,
                           global_convergence_tol=1e-12)
    assert s.A_host is None
    assert s._A64_cache is not None
    np.testing.assert_allclose(np.asarray(s._A64_cache.re), A.real,
                               rtol=0, atol=0)
    rep = s.evolve(60)
    x = rep.solutions[0][0]
    r = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert r < 1e-12


def test_1d_device_operand_clean_error(force_device_staging):
    with pytest.raises(ValueError, match="2-D"):
        api_mod.MausSolver(jnp.ones(8, jnp.complex64),
                           ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=np.ones(8))


def test_nonfinite_device_operand_rejected(force_device_staging):
    A = np.eye(8, dtype=np.complex64)
    A[3, 3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        api_mod.MausSolver(jnp.asarray(A), ProblemType.SOLVE_LINEAR_SYSTEM,
                           b_vector=np.ones(8))
