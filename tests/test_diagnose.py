"""Diagnosis regressions: condition estimation on non-normal operands and
scale-relative SVD thresholds (ADVICE r1 findings #2/#3)."""
import numpy as np

import maus_tpu
from maus_tpu.core.types import ProblemType, StabilityState
from maus_tpu.solver.diagnose import diagnose, estimate_cond


class TestCondEstimate:
    def test_nonnormal_near_singular_detected(self):
        """A large bidiagonal Jordan-like matrix has |λ_min| = 0.9 but σ_min
        astronomically small. Inverse power iteration on A itself (the r1 bug)
        returns cond ≈ 3 and classifies it STABLE; the Gram-matrix iteration
        must flag it Critical/singular."""
        n = 600   # above exact_below=512 so the estimator (not exact SVD) runs
        A = np.diag(np.full(n, 0.9 + 0j)) + np.diag(np.full(n - 1, 1.5 + 0j), 1)
        c = estimate_cond(A)
        assert (not np.isfinite(c)) or c > 1e12
        kn = diagnose(A, ProblemType.SOLVE_LINEAR_SYSTEM)
        assert kn.stability == StabilityState.CRITICAL

    def test_well_conditioned_estimate_close(self):
        rng = np.random.default_rng(0)
        n = 600
        A = np.eye(n) + 0.01 * (rng.standard_normal((n, n))
                                + 1j * rng.standard_normal((n, n)))
        c = estimate_cond(A)
        c_true = np.linalg.cond(A)
        assert 0.3 * c_true <= c <= 3.0 * c_true


def _controlled_kappa(n: int, kappa: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(kappa), n)
    return (q1 * s[None, :]) @ q2.conj().T


class TestCondDevice:
    """On-device condition probe (c64 compute, like the GPU path)."""

    def test_moderate_kappa_accurate(self):
        import jax.numpy as jnp
        from maus_tpu.solver.diagnose import estimate_cond_device

        kappa = 1e4
        A = _controlled_kappa(256, kappa)
        c = estimate_cond_device(jnp.asarray(A, jnp.complex64))
        assert 0.2 * kappa <= c <= 5 * kappa

    def test_extreme_kappa_flagged_critical(self):
        """κ far beyond c64's factorization accuracy: the backward-residual
        signal must still flag it (order-of-magnitude) instead of flooring at
        1/ε_f32."""
        import jax.numpy as jnp
        from maus_tpu.solver.diagnose import estimate_cond_device

        A = _controlled_kappa(256, 1e13, seed=1)
        c = estimate_cond_device(jnp.asarray(A, jnp.complex64))
        assert c > 1e10


class TestSvdScaleRelative:
    def test_tiny_scaled_operand_not_flagged_null(self):
        """σ thresholds are relative to ‖A‖: a 1e-9-scaled rank-2 operand must
        still recover its two singular triplets, not instantly 'converge' to
        all-zero singular values (the r1 absolute-1e-8 cut)."""
        from maus_tpu.problems import generators as gen

        A = np.asarray(gen.low_rank_svd_matrix(5, 4, seed=0)) * 1e-9
        rep = maus_tpu.svd(A, tol=1e-6, max_iterations=60, num_candidates=12)
        sigmas = sorted((s[0] for s in rep.solutions), reverse=True)
        assert len(sigmas) >= 2
        assert np.isclose(sigmas[0], 5e-9, rtol=1e-3)
        assert np.isclose(sigmas[1], 2.5e-9, rtol=1e-3)
