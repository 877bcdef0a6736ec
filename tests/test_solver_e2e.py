"""End-to-end integration tests reproducing the reference's 4 demo scenarios
(AMS:641-665) plus the survey's N=64 benchmark configs (BASELINE.md rows 7-8) —
with convergence *assertions* instead of prints (SURVEY.md §4).
"""
import numpy as np
import pytest

import maus_tpu
from maus_tpu.problems import generators as gen


class TestLinear:
    def test_n64_well_conditioned_to_1e8(self):
        """BASELINE.md row 7: the reference never converges here; we must."""
        A, b = gen.well_conditioned_system(64, seed=0)
        rep = maus_tpu.solve(A, b, tol=1e-8, max_iterations=50, num_candidates=15)
        assert rep.converged
        x = rep.best()[0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8

    def test_scenario1_dynamic_n5(self):
        """Reference scenario 1 (AMS:643-653): N=5 dynamic ill-conditioned system,
        including the mid-run matrix swap via update_problem."""
        solver = maus_tpu.MausSolver(np.eye(5), maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                     b_vector=np.ones(5),
                                     initial_num_candidates=15,
                                     global_convergence_tol=1e-7)
        A, b = gen.dynamic_solve_system(5, t_step=19, time_max_iter=20)
        solver.update_problem(matrix=A, b_vector=b)
        rep = solver.evolve(max_iterations=50)
        assert rep.num_distinct >= 1
        x = rep.best()[0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-7

    def test_hilbert_ill_conditioned(self):
        """BASELINE.md row 8 family (κ ≈ 1e8 at N=8; boosted Hilbert at N=64)."""
        A, b = gen.dynamic_solve_system(64, t_step=0, time_max_iter=100)
        rep = maus_tpu.solve(A, b, tol=1e-8, max_iterations=60, num_candidates=15)
        assert rep.num_distinct >= 1
        x = rep.best()[0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8

    def test_controlled_condition_number(self):
        A, b = gen.ill_conditioned_system(128, cond=1e6, seed=1)
        rep = maus_tpu.solve(A, b, tol=1e-8, max_iterations=60, num_candidates=8)
        assert rep.num_distinct >= 1
        x = rep.best()[0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8

    def test_sparse_csc_input(self):
        sp = pytest.importorskip("scipy.sparse")
        A = sp.csc_matrix(np.diag(np.arange(1.0, 9.0)))
        b = np.ones(8)
        rep = maus_tpu.solve(A, b, tol=1e-8, max_iterations=30, num_candidates=8)
        assert rep.knowledge.is_sparse_input
        assert rep.converged


class TestEigen:
    def test_scenario2a_general_complex(self):
        """Reference scenario 2A (AMS:654-657): all 8 eigenpairs, not just 2."""
        A = gen.laplace_like_complex(8, make_hermitian=False)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=80, num_candidates=30)
        assert rep.num_distinct == 8
        w_true = np.sort_complex(np.linalg.eigvals(A))
        w_found = np.sort_complex(np.array([s[0] for s in rep.solutions]))
        assert np.max(np.abs(w_true - w_found)) < 1e-5
        for lam, v in rep.solutions:
            assert np.linalg.norm(A @ v - lam * v) < 1e-6

    def test_scenario2b_hermitian(self):
        """Reference scenario 2B (AMS:658-661): eigh fast path. Reference stalls at
        2/8 (diversity collapse, SURVEY §0.1) — we require full coverage."""
        A = gen.laplace_like_complex(8, make_hermitian=True)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=50, num_candidates=30)
        assert rep.num_distinct == 8
        assert rep.knowledge.is_hermitian
        w_true = np.sort(np.linalg.eigvalsh(A))
        w_found = np.sort([s[0].real for s in rep.solutions])
        assert np.max(np.abs(w_true - w_found)) < 1e-9

    def test_hermitian_coverage_exceeds_population_rounds(self):
        """Coverage must grow across respawn rounds even when capacity < N."""
        A = gen.hermitian_matrix(12, seed=3)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=40, num_candidates=6)
        # capacity 6 < 12 eigenpairs: at most 6 leaders can be held at once; the
        # target is clamped to capacity and must be met
        assert rep.num_distinct == rep.target_solutions == 6

    def test_general_eig_residuals(self):
        rng = np.random.default_rng(7)
        A = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
        rep = maus_tpu.eig(A, tol=1e-6, max_iterations=150, num_candidates=48)
        assert rep.num_distinct >= 8   # meta-heuristic: most of the spectrum
        for lam, v in rep.solutions:
            assert np.linalg.norm(A @ v - lam * v) < 1e-5


class TestSVD:
    def test_scenario3_low_rank(self):
        """Reference scenario 3 (AMS:662-665): 5×4 rank-2. Reference found 1/4
        triplets; we require both dominant triplets."""
        A = gen.low_rank_svd_matrix(5, 4, target_rank=2)
        rep = maus_tpu.svd(A, tol=1e-6, max_iterations=100, num_candidates=25)
        assert rep.num_distinct == 2
        s_true = np.linalg.svd(A, compute_uv=False)[:2]
        s_found = sorted([s[0] for s in rep.solutions], reverse=True)
        assert np.allclose(s_found, s_true, rtol=1e-4)
        for sig, u, v in rep.solutions:
            assert np.linalg.norm(A @ v - sig * u) < 1e-4

    def test_rectangular_tall(self):
        A = gen.low_rank_svd_matrix(32, 8, target_rank=3, seed=5)
        rep = maus_tpu.svd(A, tol=1e-6, max_iterations=150, num_candidates=16)
        assert rep.num_distinct >= 3
        s_true = np.linalg.svd(A, compute_uv=False)[:3]
        s_found = sorted([s[0] for s in rep.solutions], reverse=True)[:3]
        assert np.allclose(s_found, s_true, rtol=1e-3)


class TestReportAndValidation:
    def test_missing_b_raises(self):
        with pytest.raises(ValueError, match="b_vector"):
            maus_tpu.MausSolver(np.eye(4), maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM)

    def test_rectangular_eig_raises(self):
        with pytest.raises(ValueError, match="square"):
            maus_tpu.eig(np.ones((3, 4)))

    def test_1d_operand_raises(self):
        with pytest.raises(ValueError, match="2-D"):
            maus_tpu.solve(np.ones(4), np.ones(4))

    def test_metrics_collection(self):
        A, b = gen.well_conditioned_system(16, seed=2)
        s = maus_tpu.MausSolver(A, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b, initial_num_candidates=8)
        rep = s.evolve(max_iterations=20, collect_metrics=True)
        assert rep.metrics is not None
        assert rep.metrics["landscape_energy"].shape == (20,)
        assert rep.metrics["num_distinct"].max() >= 1

    def test_determinism(self):
        A, b = gen.well_conditioned_system(16, seed=2)
        r1 = maus_tpu.solve(A, b, max_iterations=20, num_candidates=8, seed=3)
        r2 = maus_tpu.solve(A, b, max_iterations=20, num_candidates=8, seed=3)
        assert r1.iterations == r2.iterations
        np.testing.assert_array_equal(r1.best()[0], r2.best()[0])


class TestHermitianLanczosPath:
    def test_sparse_hermitian_routes_to_lanczos_and_converges(self):
        """Sparse-classified Hermitian input takes the deflated-Lanczos path
        (reference eigsh branch) and still finds distinct extremal eigenpairs."""
        import scipy.sparse as sp
        n = 48
        rng = np.random.default_rng(4)
        d = rng.standard_normal(n) * 3
        off = rng.standard_normal(n - 1) * 0.5
        A_dense = np.diag(d) + np.diag(off, 1) + np.diag(off, -1)
        A = sp.csc_matrix(A_dense)
        rep = maus_tpu.eig(A, tol=1e-6, max_iterations=30, num_candidates=8)
        assert rep.knowledge.is_hermitian and rep.knowledge.is_sparse_input
        assert rep.num_distinct >= 4
        w_true = np.linalg.eigvalsh(A_dense)
        for lam, v in rep.solutions:
            assert np.min(np.abs(w_true - lam.real)) < 1e-5
            assert np.linalg.norm(A_dense @ v - lam * v) < 1e-5

    def test_large_n_threshold_switch(self):
        """Config with a tiny eigh_max_n forces the Lanczos path on a dense
        Hermitian operand; results match the eigh path's extremal pairs."""
        A = gen.hermitian_matrix(32, seed=5)
        cfg = maus_tpu.SolverConfig(problem_type=maus_tpu.ProblemType.EIGENVALUE,
                                    num_candidates=8, tol=1e-6, eigh_max_n=16,
                                    dtype=np.complex128)
        s = maus_tpu.MausSolver(A, maus_tpu.ProblemType.EIGENVALUE, config=cfg,
                                global_convergence_tol=1e-6)
        rep = s.evolve(max_iterations=30)
        assert rep.num_distinct >= 4
        w_true = np.linalg.eigvalsh(A)
        for lam, v in rep.solutions:
            assert np.min(np.abs(w_true - lam.real)) < 1e-5


class TestHPDCholeskyPath:
    def test_hpd_system_diagnosed_and_solved(self):
        rng = np.random.default_rng(9)
        G = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
        A = G @ G.conj().T + 32 * np.eye(32)     # HPD
        b = rng.standard_normal(32)
        s = maus_tpu.MausSolver(A, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=b, initial_num_candidates=6)
        assert s.knowledge.is_positive_definite and s.knowledge.is_hermitian
        rep = s.evolve(max_iterations=40)
        assert rep.converged
        x = rep.best()[0]
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-8

    def test_indefinite_hermitian_not_flagged_pd(self):
        A = np.diag([1.0, -2.0, 3.0])
        s = maus_tpu.MausSolver(A, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                b_vector=np.ones(3), initial_num_candidates=4)
        assert s.knowledge.is_hermitian and not s.knowledge.is_positive_definite


class TestBaselineConfigs:
    """The judge's config list (BASELINE.json): the two not covered elsewhere."""

    def test_noncommuting_eig_via_forced_gmres(self):
        """Config 4: non-Hermitian eig solved through the GMRES+Jacobi path
        (exercised directly — in production it engages via failover)."""
        import dataclasses
        import jax
        import jax.numpy as jnp
        from maus_tpu.core.types import (SolverConfig, SolverPreference,
                                         initial_strategy, ProblemKnowledge)
        from maus_tpu.solver import candidate as cand

        A_h = gen.laplace_like_complex(8, make_hermitian=False)
        cfg = SolverConfig(problem_type=maus_tpu.ProblemType.EIGENVALUE,
                           num_candidates=16, tol=1e-6, dtype=jnp.complex128)
        kn = ProblemKnowledge(shape=(8, 8))
        A = jnp.asarray(A_h, cfg.dtype)
        pop = cand.init_population(cfg, jax.random.PRNGKey(0), (8, 8))
        strat = dataclasses.replace(
            initial_strategy(cfg, kn),
            solver_pref=jnp.asarray(int(SolverPreference.GMRES), jnp.int32))
        for _ in range(25):
            pop, stats = cand.step_eigen(cfg, A, pop, strat)
        res = np.asarray(pop.residual)
        assert np.sum(res < 1e-6) >= 4     # GMRES path converges candidates
        w_true = np.linalg.eigvals(A_h)
        lam = np.asarray(pop.lam)[res < 1e-6]
        for l in lam:
            assert np.min(np.abs(w_true - l)) < 1e-4

    def test_rectangular_sparse_csc_svd(self):
        """Config 5 (shrunk for CPU): rectangular sparse-CSC input maps to the
        dense device layout and SVD mode finds the dominant triplets."""
        sp = pytest.importorskip("scipy.sparse")
        rng = np.random.default_rng(11)
        A_sp = sp.random(128, 32, density=0.08, random_state=rng,
                         data_rvs=rng.standard_normal, format="csc")
        A_dense = A_sp.toarray()
        rep = maus_tpu.svd(A_sp, tol=1e-4, max_iterations=200,
                           num_candidates=12)
        assert rep.knowledge.is_sparse_input
        s_true = np.linalg.svd(A_dense, compute_uv=False)
        found = sorted([s[0] for s in rep.solutions], reverse=True)
        assert len(found) >= 3
        for f, t in zip(found[:3], s_true[:3]):
            assert abs(f - t) / t < 1e-2


class TestEdgeCases:
    def test_identity_matrix_solve(self):
        """The reference misclassifies eye(5) as sparse+Critical (SURVEY §0.1);
        we must classify it sane and solve it exactly."""
        rep = maus_tpu.solve(np.eye(5), np.arange(1.0, 6.0), max_iterations=20,
                             num_candidates=4)
        assert rep.converged
        np.testing.assert_allclose(rep.best()[0], np.arange(1.0, 6.0),
                                   atol=1e-10)

    def test_one_by_one(self):
        rep = maus_tpu.solve(np.array([[4.0]]), np.array([8.0]),
                             max_iterations=10, num_candidates=2)
        assert rep.converged
        np.testing.assert_allclose(rep.best()[0], [2.0], atol=1e-10)
        rep = maus_tpu.eig(np.array([[3.0]]), max_iterations=10,
                           num_candidates=2)
        assert rep.num_distinct == 1
        assert abs(rep.solutions[0][0] - 3.0) < 1e-8

    def test_zero_matrix_svd(self):
        """All singular values zero: the zero-SV branch converges null vectors."""
        rep = maus_tpu.svd(np.zeros((4, 3)), tol=1e-6, max_iterations=20,
                           num_candidates=6)
        for sig, u, v in rep.solutions:
            assert sig == 0.0

    def test_real_valued_inputs(self):
        """Real (non-complex) numpy inputs are accepted and solved."""
        rng = np.random.default_rng(0)
        A = rng.standard_normal((12, 12)) + 12 * np.eye(12)
        b = rng.standard_normal(12)
        rep = maus_tpu.solve(A, b, max_iterations=30, num_candidates=4)
        assert rep.converged

    def test_nonfinite_rejected(self):
        A = np.eye(3)
        A[0, 0] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            maus_tpu.solve(A, np.ones(3))
        with pytest.raises(ValueError, match="non-finite"):
            maus_tpu.solve(np.eye(3), np.array([1.0, np.inf, 0.0]))


class TestUpdateProblemParity:
    """update_problem must stage/diagnose exactly like the constructor
    (VERDICT r2 #8): a swapped Hermitian operand keeps the fast path, and a
    b-only swap keeps the cached full-precision planes."""

    def test_hermitian_swap_keeps_fast_path(self):
        rng = np.random.default_rng(3)
        n = 48
        solver = maus_tpu.MausSolver(np.eye(n), maus_tpu.ProblemType.EIGENVALUE,
                                     initial_num_candidates=8)
        G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        H = (G + G.conj().T) / 2
        solver.update_problem(matrix=H)
        assert solver.knowledge.is_hermitian
        rep = solver.evolve(max_iterations=30)
        lam_true = np.sort(np.linalg.eigvalsh(H))
        for lam, v in rep.solutions:
            assert np.min(np.abs(lam_true - lam.real)) < 1e-6

    def test_b_only_swap_keeps_a64_cache(self):
        rng = np.random.default_rng(4)
        n = 24
        A = rng.standard_normal((n, n)) + n * np.eye(n)
        solver = maus_tpu.MausSolver(A, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                     b_vector=np.ones(n),
                                     initial_num_candidates=4)
        solver.evolve(max_iterations=20)
        cache0 = solver._A64_cache
        solver.update_problem(b_vector=rng.standard_normal(n))
        assert solver._A64_cache is cache0      # A unchanged -> planes kept
        assert solver._fac_cache is None        # psi-shifted factor dropped
        rep = solver.evolve(max_iterations=20)
        assert rep.num_distinct >= 1

    def test_b_shape_mismatch_raises(self):
        solver = maus_tpu.MausSolver(np.eye(5), maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                                     b_vector=np.ones(5))
        with pytest.raises(ValueError, match="does not match"):
            solver.update_problem(b_vector=np.ones(6))


class TestFinalDedupDeterminism:
    """Host-side hysteresis-banded dedup (VERDICT r2 #7): counts must be
    invariant under the ~eps-level value jitter XLA recompilation introduces
    at the similarity thresholds."""

    def test_counts_stable_under_jitter(self):
        from maus_tpu.core.types import SolverConfig
        from maus_tpu.solver.api import _final_dedup
        cfg = SolverConfig(problem_type=maus_tpu.ProblemType.EIGENVALUE)
        rng = np.random.default_rng(0)
        n = 16
        v1 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        v1 /= np.linalg.norm(v1)
        v2 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        v2 /= np.linalg.norm(v2)
        # cluster A: two copies of (lam, v1) separated by exactly the DEVICE
        # threshold (1e-5) — the flip-prone configuration; cluster B: far away
        base = [(1.0 + 0.0j, v1), (1.0 + 1e-5 * 0.999j, v1),
                (3.0 + 0.0j, v2)]
        counts = set()
        for trial in range(50):
            jit = 1e-9 * rng.standard_normal(3)
            sols = [(lam + jit[i], v) for i, (lam, v) in enumerate(base)]
            res = list(1e-12 + 1e-13 * rng.random(3))
            kept, _ = _final_dedup(cfg, maus_tpu.ProblemType.EIGENVALUE,
                                   sols, res)
            counts.add(len(kept))
        assert counts == {2}       # cluster A merges, cluster B survives

    def test_distinct_pairs_not_merged(self):
        from maus_tpu.core.types import SolverConfig
        from maus_tpu.solver.api import _final_dedup
        cfg = SolverConfig(problem_type=maus_tpu.ProblemType.SVD)
        rng = np.random.default_rng(1)
        u = rng.standard_normal(8); u /= np.linalg.norm(u)
        v = rng.standard_normal(8); v /= np.linalg.norm(v)
        u2 = rng.standard_normal(8); u2 /= np.linalg.norm(u2)
        v2 = rng.standard_normal(8); v2 /= np.linalg.norm(v2)
        sols = [(5.0, u, v), (2.5, u2, v2)]
        kept, _ = _final_dedup(cfg, maus_tpu.ProblemType.SVD, sols,
                               [1e-10, 1e-10])
        assert len(kept) == 2
