"""Mixed-precision eig/SVD finishers (VERDICT r1 #2).

All inputs are deliberately complex64 — the GPU compute dtype — while truth and
residuals are f64: these tests exercise exactly the precision gap the finishers
exist to close (c64 floor ≈ √N·ε_f32 → tol 1e-8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import maus_tpu
from maus_tpu.core.types import ProblemType, SolverConfig
from maus_tpu.ops.refine import SplitComplex
from maus_tpu.ops.refine_eig import refine_eigenpairs, refine_svd_triplets


def _split64(A):
    return SplitComplex(jnp.asarray(A.real.astype(np.float64)),
                        jnp.asarray(A.imag.astype(np.float64)))


class TestEigenpairNewton:
    def _check(self, A, rtol=1e-11):
        n = A.shape[0]
        w, V = np.linalg.eig(A)
        rng = np.random.default_rng(1)
        k = 6
        pick = rng.choice(n, size=k, replace=False)
        v0 = V[:, pick].T + 1e-4 * (rng.standard_normal((k, n))
                                    + 1j * rng.standard_normal((k, n)))
        v0 = v0 / np.linalg.norm(v0, axis=1, keepdims=True)
        lam0 = w[pick] * (1 + 1e-5) + 1e-5
        lam_s, V_s, res = refine_eigenpairs(
            _split64(A), jnp.asarray(lam0, jnp.complex64),
            jnp.asarray(v0, jnp.complex64), steps=5)
        res = np.asarray(res)
        anorm = np.linalg.norm(A, 2)
        assert np.all(res < rtol * anorm), res / anorm
        lam_ref = np.asarray(lam_s.re) + 1j * np.asarray(lam_s.im)
        for j in range(k):
            assert np.min(np.abs(w - lam_ref[j])) < rtol * anorm

    def test_hermitian(self):
        rng = np.random.default_rng(0)
        B = rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48))
        self._check((B + B.conj().T) / 2)

    def test_nonnormal(self):
        rng = np.random.default_rng(2)
        A = rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48))
        self._check(A, rtol=1e-10)


class TestPsiContinuation:
    """The ψ regularization perturbs the Newton Jacobian: a FIXED ψ is an
    inexact-Newton stall on pseudospectrally ill-conditioned pairs of
    non-normal operands (measured, N=4096 Ginibre c64-floor starts: 3/16
    stalled at 6e-5..8e-5 with fixed psi_rel=3e-6; psi_rel=1e-10 converged
    all three to ≤1.2e-13; the exact ψ=0 f64 bordered solve converges
    quadratically from the stuck state). refine_eigenpairs therefore decays
    ψ per round toward 1e-4·resid, and _bordered_newton ADVANCES through
    finite-but-worse steps (in-place rejection at a fixed factorization is
    an absorbing state: the rejected step recomputes identically forever —
    the measured stragglers' first step rises 6.06e-5 → 6.93e-5, then falls
    to 4e-11 if allowed to proceed). The at-scale reproducer lives in
    benchmarks/spectral_large_probe.py (eig N=4096 general row); these
    CPU-budget tests pin the mechanism's contract."""

    def test_nonnormal_floor_start_reaches_f64_defaults(self):
        """Worst eigenvector-condition pairs of a non-normal operand, started
        at the engine's c64 acceptance floor, must reach f64 residuals with
        DEFAULT arguments (no caller-side ψ tuning)."""
        rng = np.random.default_rng(7)
        n, k = 256, 8
        A = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)
        w, V = np.linalg.eig(A)
        kappa = (np.linalg.norm(V, axis=0)
                 * np.linalg.norm(np.linalg.inv(V), axis=1))
        pick = np.argsort(-kappa)[:k]
        v0 = V[:, pick].T / np.linalg.norm(V[:, pick].T, axis=1, keepdims=True)
        noise = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
        noise /= np.linalg.norm(noise, axis=1, keepdims=True)
        v0 = v0 + 3e-4 * noise
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
        lam0 = w[pick] + 3e-5 * (rng.standard_normal(k)
                                 + 1j * rng.standard_normal(k))
        lam_s, V_s, res = refine_eigenpairs(
            _split64(A), jnp.asarray(lam0.astype(np.complex64)),
            jnp.asarray(v0.astype(np.complex64)), steps=5)
        assert np.all(np.asarray(res) <= 1e-11), np.asarray(res)

    def test_tiny_psi_matches_default_on_normal_operand(self):
        """ψI commutes with A, so on a NORMAL operand the continuation must
        be inert: tiny-ψ and default-ψ runs both land at f64 residuals."""
        rng = np.random.default_rng(8)
        n, k = 96, 5
        B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A = (B + B.conj().T) / 2
        w, V = np.linalg.eigh(A)
        pick = rng.choice(n, size=k, replace=False)
        v0 = (V[:, pick].T + 1e-4 * rng.standard_normal((k, n))).astype(complex)
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
        lam0 = w[pick].astype(complex) + 1e-5
        for psi_rel in (3e-6, 1e-10):
            _, _, res = refine_eigenpairs(
                _split64(A), jnp.asarray(lam0.astype(np.complex64)),
                jnp.asarray(v0.astype(np.complex64)), steps=5,
                psi_rel=psi_rel)
            assert np.all(np.asarray(res) <= 1e-11 * np.abs(w).max())


class TestSvdNewton:
    def test_triplets_reach_f64(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((40, 32)) + 1j * rng.standard_normal((40, 32))
        U, s, Vh = np.linalg.svd(A, full_matrices=False)
        k = 5
        u0 = U[:, :k].T + 1e-4 * (rng.standard_normal((k, 40))
                                  + 1j * rng.standard_normal((k, 40)))
        v0 = Vh[:k].conj() + 1e-4 * (rng.standard_normal((k, 32))
                                     + 1j * rng.standard_normal((k, 32)))
        sig0 = s[:k] * (1 + 1e-4)
        sig, U_s, V_s, res = refine_svd_triplets(
            _split64(A), jnp.asarray(sig0, jnp.complex64),
            jnp.asarray(u0, jnp.complex64), jnp.asarray(v0, jnp.complex64),
            steps=6)
        res = np.asarray(res)
        anorm = s[0]
        assert np.all(res < 1e-10 * anorm), res / anorm
        assert np.allclose(np.asarray(sig), s[:k], rtol=1e-10)

    def test_small_sigma_residual_is_honest(self):
        """A σ≈0 (null-vector) candidate passes through UNCHANGED — the
        reported residual must be the residual of the returned (unchanged)
        triplet, not a min over trial states that were never returned
        (code-review r3, reproduced: reported 1.044 vs actual 1.273)."""
        rng = np.random.default_rng(5)
        m, n = 32, 24
        B = rng.standard_normal((m, 3)) + 1j * rng.standard_normal((m, 3))
        C = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        A = B @ C                                       # rank 3: null σ exist
        # a small-σ candidate with deliberately imperfect u, v
        u0 = (rng.standard_normal((1, m)) + 1j * rng.standard_normal((1, m)))
        v0 = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n)))
        u0 /= np.linalg.norm(u0)
        v0 /= np.linalg.norm(v0)
        sig0 = np.asarray([0.0])
        sig, U_s, V_s, res = refine_svd_triplets(
            _split64(A), jnp.asarray(sig0, jnp.complex64),
            jnp.asarray(u0, jnp.complex64), jnp.asarray(v0, jnp.complex64),
            steps=4)
        sig_h = np.asarray(sig)
        u_h = np.asarray(U_s.re) + 1j * np.asarray(U_s.im)
        v_h = np.asarray(V_s.re) + 1j * np.asarray(V_s.im)
        actual = (np.linalg.norm(A @ v_h[0] - sig_h[0] * u_h[0])
                  + np.linalg.norm(A.conj().T @ u_h[0] - sig_h[0] * v_h[0]))
        assert np.asarray(res)[0] == pytest.approx(actual, rel=1e-10)


class TestApiEngagement:
    def test_eig_c64_reaches_1e8(self):
        """End-to-end in the GPU compute dtype: the evolve loop accepts at the
        c64 floor, the finisher must deliver residuals ≤ 1e-8 in the report."""
        from maus_tpu.problems import generators as gen

        Ah = gen.laplace_like_complex(8, make_hermitian=True)
        cfg = SolverConfig(problem_type=ProblemType.EIGENVALUE,
                           num_candidates=30, tol=1e-8, dtype=jnp.complex64,
                           convergence_floor=5e-6)
        s = maus_tpu.MausSolver(Ah, ProblemType.EIGENVALUE, config=cfg)
        rep = s.evolve(max_iterations=60)
        assert rep.num_distinct == 8
        assert max(rep.residuals) <= 1e-8

    def test_svd_c64_reaches_1e6(self):
        from maus_tpu.problems import generators as gen

        A = np.asarray(gen.low_rank_svd_matrix(5, 4, seed=0))
        cfg = SolverConfig(problem_type=ProblemType.SVD,
                           num_candidates=12, tol=1e-6, dtype=jnp.complex64,
                           convergence_floor=5e-6)
        s = maus_tpu.MausSolver(A, ProblemType.SVD, config=cfg)
        rep = s.evolve(max_iterations=80)
        assert rep.num_distinct >= 2
        big = [r for sol, r in zip(rep.solutions, rep.residuals)
               if sol[0] > 1e-3]
        assert big and max(big) <= 1e-6


class TestCrudeStartPrePolish:
    """Engine leaders that converged at a loose EARLY threshold can be ~0.1
    off their eigenvector (measured at 8192² on chip: leaders at 2.6e-3 kept
    their residuals through 5 plain Newton steps). The finishers now run two
    masked shifted-inverse-iteration pre-sweeps; these tests pin recovery
    from crude starts that plain Newton loses."""

    def test_eig_crude_start_recovers(self):
        rng = np.random.default_rng(3)
        n, k = 96, 5
        A = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
        w, V = np.linalg.eig(A)
        pick = rng.choice(n, size=k, replace=False)
        # crude: 10% vector noise, 1e-2-scale eigenvalue error
        v0 = V[:, pick].T + 0.1 * (rng.standard_normal((k, n))
                                   + 1j * rng.standard_normal((k, n))) \
            / np.sqrt(n) * np.sqrt(n) * 0.1
        lam0 = w[pick] + 1e-3 * (rng.standard_normal(k)
                                 + 1j * rng.standard_normal(k))
        lam_s, V_s, res = refine_eigenpairs(
            _split64(A), jnp.asarray(lam0.astype(np.complex64)),
            jnp.asarray(v0.astype(np.complex64)), steps=6)
        assert np.all(np.asarray(res) < 1e-10)

    def test_eig_precise_start_untouched_quality(self):
        """The pre-sweep mask must not degrade already-good starts."""
        rng = np.random.default_rng(4)
        n, k = 96, 4
        A = (rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
        w, V = np.linalg.eig(A)
        pick = rng.choice(n, size=k, replace=False)
        v0 = V[:, pick].T + 1e-7 * (rng.standard_normal((k, n))
                                    + 1j * rng.standard_normal((k, n)))
        lam_s, V_s, res = refine_eigenpairs(
            _split64(A), jnp.asarray(w[pick].astype(np.complex64)),
            jnp.asarray(v0.astype(np.complex64)), steps=4)
        assert np.all(np.asarray(res) < 1e-11)

    def test_svd_crude_start_recovers(self):
        rng = np.random.default_rng(5)
        m, n, k = 48, 32, 3
        U, _ = np.linalg.qr(rng.standard_normal((m, n))
                            + 1j * rng.standard_normal((m, n)))
        V, _ = np.linalg.qr(rng.standard_normal((n, n))
                            + 1j * rng.standard_normal((n, n)))
        s = np.logspace(0, -1, n)
        A = (U[:, :n] * s) @ V.conj().T
        pick = np.array([0, 4, 9])
        u0 = U[:, pick].T + 0.1 * (rng.standard_normal((k, m))
                                   + 1j * rng.standard_normal((k, m)))
        v0 = V[:, pick].T + 0.1 * (rng.standard_normal((k, n))
                                   + 1j * rng.standard_normal((k, n)))
        sig0 = s[pick] * (1 + 1e-2 * rng.standard_normal(k))
        sig, U_s, V_s, res = refine_svd_triplets(
            _split64(A), jnp.asarray(sig0.astype(np.complex64)),
            jnp.asarray(u0.astype(np.complex64)),
            jnp.asarray(v0.astype(np.complex64)), steps=6)
        assert np.all(np.asarray(res) < 1e-9)
