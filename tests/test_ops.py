"""Unit tests for the ops layer: regularized solves, GMRES, refinement.

Kernels are tested against ``jnp.linalg`` / numpy oracles, per SURVEY.md §4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maus_tpu.ops import batched_solve as bs
from maus_tpu.ops import gmres as gm
from maus_tpu.ops import refine as rf
from maus_tpu.ops import regularize as reg


def _rand_complex(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


class TestRegularize:
    def test_psi_magnitude_schedule(self):
        # Ψ = base · aggression · 10^(attempt/2) · 10^(stuck/3)  (AMS:44)
        v = reg.psi_magnitude(1e-12, 2.0, 2, 3)
        assert np.isclose(float(v), 1e-12 * 2.0 * 10.0 * 10.0)

    def test_apply_shift_adds_diagonal(self):
        A = jnp.zeros((4, 4), jnp.complex128)
        H = reg.apply_shift(A, 1.0)
        d = np.diag(np.asarray(H))
        assert np.all(d.real >= 1.0) and np.all(d.real <= 1.15 + 1e-9)
        assert np.allclose(np.asarray(H) - np.diag(d), 0)

    def test_apply_shift_extra_diag(self):
        A = jnp.eye(3, dtype=jnp.complex128)
        lam = 0.5 + 0.25j
        H = reg.apply_shift(A, 0.0, extra_diag=-lam * jnp.ones(3, jnp.complex128))
        assert np.allclose(np.diag(np.asarray(H)), 1.0 - lam)


class TestBatchedSolve:
    def test_shared_factor_solve_matches_oracle(self):
        rng = np.random.default_rng(0)
        A = jnp.asarray(_rand_complex(rng, 16, 16) + 16 * np.eye(16))
        b = jnp.asarray(_rand_complex(rng, 16))
        x, attempts = bs.shared_factor_solve(A, 1e-14, 1.0, b)
        assert int(attempts) == 0
        assert np.linalg.norm(np.asarray(A) @ np.asarray(x) - np.asarray(b)) < 1e-10

    def test_batched_shifted_solve(self):
        rng = np.random.default_rng(1)
        N, K = 12, 5
        A = jnp.asarray(_rand_complex(rng, N, N))
        lams = jnp.asarray(_rand_complex(rng, K) * 3)
        B = jnp.asarray(_rand_complex(rng, K, N))
        stuck = jnp.zeros((K,), jnp.int32)
        W, attempts = bs.batched_shifted_solve(A, lams, stuck, 1e-14, 1.0, B)
        An, Wn, Bn = map(np.asarray, (A, W, B))
        for k in range(K):
            H = An - complex(lams[k]) * np.eye(N)
            # Ψ jitter is tiny; compare against the unshifted oracle
            assert np.linalg.norm(H @ Wn[k] - Bn[k]) / np.linalg.norm(Bn[k]) < 1e-8

    def test_ladder_escalates_on_singular(self):
        # exactly singular matrix: direct solve of A is inf/nan → ladder must
        # escalate Ψ until the regularized system is solvable
        A = jnp.asarray(np.diag([1.0, 1.0, 0.0]).astype(np.complex128))
        b = jnp.asarray(np.array([1.0, 1.0, 1.0], np.complex128))
        x, attempts = bs.shared_factor_solve(A, 1e-12, 1.0, b, max_attempts=25)
        assert np.all(np.isfinite(np.asarray(x).view(np.float64)))


class TestGMRES:
    def test_matches_direct_solve(self):
        rng = np.random.default_rng(2)
        N, K = 24, 4
        As = np.stack([_rand_complex(rng, N, N) + N * np.eye(N) for _ in range(K)])
        B = _rand_complex(rng, K, N)
        Aj, Bj = jnp.asarray(As), jnp.asarray(B)

        def matvec(X):
            return jnp.einsum("kij,kj->ki", Aj, X)

        res = gm.gmres_batched(matvec, Bj, tol=1e-10, restart=24, max_restarts=4)
        assert bool(jnp.all(res.converged))
        for k in range(K):
            x_true = np.linalg.solve(As[k], B[k])
            assert np.linalg.norm(np.asarray(res.x)[k] - x_true) / \
                np.linalg.norm(x_true) < 1e-7

    def test_jacobi_preconditioner_helps_diagonal_dominance(self):
        rng = np.random.default_rng(3)
        N = 32
        d = np.logspace(0, 4, N)
        A = np.diag(d).astype(np.complex128) + 0.01 * _rand_complex(rng, N, N)
        b = _rand_complex(rng, N)
        Aj = jnp.asarray(A[None])
        Minv = gm.jacobi_from_diag(jnp.asarray(np.diag(A)[None]))
        res = gm.gmres_batched(lambda X: jnp.einsum("kij,kj->ki", Aj, X),
                               jnp.asarray(b[None]), precond_diag=Minv,
                               tol=1e-10, restart=32, max_restarts=4)
        x_true = np.linalg.solve(A, b)
        assert np.linalg.norm(np.asarray(res.x)[0] - x_true) / \
            np.linalg.norm(x_true) < 1e-6

    def test_jacobi_guards(self):
        # non-finite / tiny diagonal entries fall back to 1 (AMS:64-87 semantics)
        d = jnp.asarray([1.0 + 0j, 0.0, jnp.nan, 1e-15, 2.0])
        minv = np.asarray(gm.jacobi_from_diag(d))
        assert np.allclose(minv[[1, 2, 3]], 1.0)
        assert np.isclose(minv[4], 0.5)


class TestRefine:
    def test_refinement_reaches_f64(self):
        rng = np.random.default_rng(4)
        N = 48
        A128 = _rand_complex(rng, N, N) + N * np.eye(N)
        b128 = _rand_complex(rng, N)
        A = jnp.asarray(A128, jnp.complex64)
        b = jnp.asarray(b128, jnp.complex64)
        fac = bs.factor(A)
        x0 = bs.solve_factored(fac, b)
        rel0 = float(rf.true_residual_norm(A, x0, b))
        assert rel0 > 1e-9          # c64 solve alone cannot reach f64 depths
        # refine against the ORIGINAL f64 operands (c64 factorization is only the
        # preconditioner): the result must solve the true system to ~f64 depth
        A_split = rf.SplitComplex(jnp.asarray(A128.real), jnp.asarray(A128.imag))
        b_split = rf.SplitComplex(jnp.asarray(b128.real), jnp.asarray(b128.imag))
        xs, rel = rf.refine_split(A_split, fac, b_split, x0, steps=3)
        assert float(rel) < 1e-12
        x128 = np.asarray(xs.re) + 1j * np.asarray(xs.im)
        true_rel = np.linalg.norm(A128 @ x128 - b128) / np.linalg.norm(b128)
        assert true_rel < 1e-11

    def test_split_matvec_matches_c128(self):
        rng = np.random.default_rng(5)
        A = _rand_complex(rng, 8, 8)
        x = _rand_complex(rng, 8)
        As = rf.SplitComplex.from_complex(jnp.asarray(A, jnp.complex64))
        xs = rf.SplitComplex.from_complex(jnp.asarray(x, jnp.complex64))
        y = rf.split_matvec(As, xs)
        y_ref = A.astype(np.complex64) @ x.astype(np.complex64)
        got = np.asarray(y.re) + 1j * np.asarray(y.im)
        assert np.linalg.norm(got - y_ref) / np.linalg.norm(y_ref) < 1e-6


class TestGMRESIR:
    def test_gmres_ir_beats_plain_ir_at_high_kappa(self):
        """κ where c64-preconditioned plain IR stalls: GMRES-IR must still reach
        near-f64 residuals (the gap-#3 fallback)."""
        from maus_tpu.problems import generators as gen
        n, kappa = 192, 3e7
        A128, b128 = gen.ill_conditioned_system(n, cond=kappa, seed=2)
        A = jnp.asarray(A128, jnp.complex64)
        b = jnp.asarray(b128, jnp.complex64)
        from maus_tpu.ops.batched_solve import factor_qr, solve_qr
        fac = factor_qr(A)
        x0 = solve_qr(fac, b)
        A_s = rf.SplitComplex(jnp.asarray(A128.real), jnp.asarray(A128.imag))
        b_s = rf.SplitComplex(jnp.asarray(b128.real), jnp.asarray(b128.imag))
        _, rel_ir = rf.refine_split(A_s, fac, b_s, x0, steps=40, tol=1e-10)
        xs, rel_g = rf.refine_gmres(A_s, fac, b_s, x0, steps=20, tol=1e-10)
        assert float(rel_g) < 1e-8
        # and it must actually beat what plain IR reached (or match if IR won)
        assert float(rel_g) <= float(rel_ir) * 1.5
        x128 = np.asarray(xs.re) + 1j * np.asarray(xs.im)
        true_rel = np.linalg.norm(A128 @ x128 - b128) / np.linalg.norm(b128)
        assert true_rel < 1e-8


class TestExplicitRinv:
    """Blocked triangular inversion (VERDICT r2 #5): GEMM-rich R^-1 whose
    application matches the backward-stable substitution to O(eps*kappa)."""

    def test_invert_triangular_blocked(self):
        from maus_tpu.ops.batched_solve import invert_triangular
        rng = np.random.default_rng(0)
        for n in (7, 128, 300, 513):
            # diagonally dominant: a RANDOM triangular matrix's condition
            # number grows exponentially in n, which would swamp any
            # inversion scheme (forward error is O(eps*kappa) for the
            # backward-stable substitution too)
            R = np.triu(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
            R += np.sqrt(n) * np.diag(3.0 + rng.random(n))
            X = np.asarray(invert_triangular(jnp.asarray(R), block=64))
            err = np.linalg.norm(R @ X - np.eye(n)) / np.sqrt(n)
            assert err < 1e-10, (n, err)   # O(eps64*kappa(R))
            assert np.allclose(np.tril(X, -1), 0)

    def test_solve_qr_with_rinv_matches(self):
        from maus_tpu.ops.batched_solve import factor_qr, solve_qr
        rng = np.random.default_rng(1)
        n = 160
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)) \
            + n * np.eye(n)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        fac_plain = factor_qr(jnp.asarray(A), with_rinv=False)
        fac_rinv = factor_qr(jnp.asarray(A), with_rinv=True)
        assert fac_rinv.rinv is not None
        x0 = np.asarray(solve_qr(fac_plain, jnp.asarray(b)))
        x1 = np.asarray(solve_qr(fac_rinv, jnp.asarray(b)))
        assert np.linalg.norm(x0 - x1) / np.linalg.norm(x0) < 1e-10
        assert np.linalg.norm(A @ x1 - b) / np.linalg.norm(b) < 1e-12
