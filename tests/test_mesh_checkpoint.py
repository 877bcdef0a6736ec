"""Mesh-path feature parity with the single-chip API (VERDICT r3 #5):
checkpoint/resume for ``solve/eig/svd(mesh=)`` — sharded carry leaves
(including the column-sharded DistQR factors) saved and restored WITH their
shardings, chunk boundaries on the same jitted loop so resume is bit-exact —
and mid-run operand swap (``MeshSolver.update_problem``, the mesh counterpart
of AMS:645-652's scenario-1 swap).

Runs on the 8-virtual-device CPU mesh (conftest).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import maus_tpu
from maus_tpu.core.types import ProblemType
from maus_tpu.problems import generators as gen

M_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < M_DEV:
        pytest.skip("needs 8 devices")
    return Mesh(np.array(jax.devices()).reshape(-1), ("model",))


def _linear_problem(n=32, seed=0, cond=1e3):
    return gen.ill_conditioned_system(n, cond=cond, seed=seed)


class TestSolveMeshCheckpoint:
    def test_resume_bit_exact(self, mesh, tmp_path):
        """Kill a mesh run mid-way, resume from the periodic checkpoint, and
        match the uninterrupted run bit-exactly (the single-chip contract of
        test_utils.test_checkpoint_every_resume_bit_exact, now on the mesh)."""
        A, b = _linear_problem(seed=3)
        path = str(tmp_path / "mesh_periodic.npz")
        common = dict(tol=1e-10, num_candidates=6, seed=5, mesh=mesh)

        rep_ref = maus_tpu.solve(A, b, max_iterations=6, **common)
        maus_tpu.solve(A, b, max_iterations=4, checkpoint_path=path,
                       checkpoint_every=2, **common)
        rep_b = maus_tpu.solve(A, b, max_iterations=6, resume_from=path,
                               **common)

        assert rep_ref.iterations == rep_b.iterations
        assert rep_ref.residuals == rep_b.residuals
        np.testing.assert_array_equal(rep_ref.solutions[0][0],
                                      rep_b.solutions[0][0])

    def test_restored_factors_keep_sharding(self, mesh, tmp_path):
        """The carry's DistQR leaves must come back column-sharded
        ((N, N/m) per device), not replicated — a replicated restore would
        silently undo the memory scaling the mesh exists for."""
        from maus_tpu.core.types import ProblemKnowledge, SolverConfig
        from maus_tpu.parallel.dist_qr import stage_operands
        from maus_tpu.solver import evolve as evolve_mod
        from maus_tpu.utils.checkpoint import load_state, save_state

        n = 32
        A, b = _linear_problem(n=n, seed=4)
        A_dev, b_dev, *_ = stage_operands(mesh, A, b)
        eps = float(np.finfo(np.float64).eps)
        cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=6, tol=1e-10, dtype=A_dev.dtype,
                           convergence_floor=50 * eps, refine=True)
        kn = ProblemKnowledge(shape=(n, n))
        key = jax.random.PRNGKey(0)
        carry = evolve_mod.init_carry(cfg, kn, A_dev, key, mesh=mesh,
                                      dist_block=4)
        path = str(tmp_path / "sharded_carry.npz")
        save_state(path, carry)
        template = evolve_mod.init_carry(cfg, kn, A_dev, key, mesh=mesh,
                                         dist_block=4)
        loaded = load_state(path, template)
        for leaf in (loaded.fac.q, loaded.fac.r):
            shards = leaf.addressable_shards
            assert len(shards) == M_DEV
            for s in shards:
                assert s.data.shape == (n, n // M_DEV)
        # and the restored values equal the saved ones exactly
        np.testing.assert_array_equal(np.asarray(loaded.fac.q),
                                      np.asarray(carry.fac.q))

    def test_disthess_roundtrip_keeps_sharding(self, mesh, tmp_path):
        """DistHess leaves save/restore WITH their column shardings too (the
        eig-mesh resume path rebuilds the reduction deterministically from
        A, but the checkpoint machinery must handle the factor pytree
        generically — VERDICT r3 #5 names DistQR AND DistHess)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from maus_tpu.parallel.dist_hessenberg import dist_hessenberg
        from maus_tpu.utils.checkpoint import load_state, save_state

        rng = np.random.default_rng(5)
        n = 32
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A_dev = jax.device_put(jnp.asarray(A),
                               NamedSharding(mesh, P(None, "model")))
        hess = dist_hessenberg(mesh, A_dev)
        path = str(tmp_path / "hess.npz")
        save_state(path, hess)
        # abstract template with explicit shardings — no rebuild needed
        col = NamedSharding(mesh, P(None, "model"))
        template = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=col),
            hess)
        loaded = load_state(path, template)
        for leaf in (loaded.h, loaded.q):
            assert len(leaf.addressable_shards) == M_DEV
            for s in leaf.addressable_shards:
                assert s.data.shape == (n, n // M_DEV)
        np.testing.assert_array_equal(np.asarray(loaded.h),
                                      np.asarray(hess.h))

    def test_checkpoint_every_requires_path(self, mesh):
        A, b = _linear_problem(seed=6)
        with pytest.raises(ValueError, match="checkpoint_path"):
            maus_tpu.solve(A, b, mesh=mesh, checkpoint_every=2)


class TestEigSvdMeshCheckpoint:
    def test_eig_resume_matches_uninterrupted(self, mesh, tmp_path):
        rng = np.random.default_rng(7)
        n = 32
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        path = str(tmp_path / "eig_mesh.npz")
        common = dict(tol=1e-8, num_candidates=8, seed=2, mesh=mesh)

        rep_ref = maus_tpu.eig(A, max_iterations=30, **common)
        maus_tpu.eig(A, max_iterations=10, checkpoint_path=path,
                     checkpoint_every=5, **common)
        rep_b = maus_tpu.eig(A, max_iterations=30, resume_from=path, **common)

        assert rep_b.iterations == rep_ref.iterations
        assert rep_b.num_distinct == rep_ref.num_distinct
        assert rep_b.residuals == rep_ref.residuals
        for (l1, v1), (l2, v2) in zip(rep_ref.solutions, rep_b.solutions):
            assert l1 == l2
            np.testing.assert_array_equal(v1, v2)

    def test_svd_resume_converges(self, mesh, tmp_path):
        rng = np.random.default_rng(8)
        mr, n = 24, 32
        B = rng.standard_normal((mr, n)) + 1j * rng.standard_normal((mr, n))
        path = str(tmp_path / "svd_mesh.npz")
        common = dict(tol=1e-8, num_candidates=6, seed=3, mesh=mesh)

        rep_ref = maus_tpu.svd(B, max_iterations=60, **common)
        maus_tpu.svd(B, max_iterations=20, checkpoint_path=path,
                     checkpoint_every=10, **common)
        rep_b = maus_tpu.svd(B, max_iterations=60, resume_from=path, **common)

        assert rep_b.iterations == rep_ref.iterations
        assert rep_b.num_distinct == rep_ref.num_distinct
        s_true = np.linalg.svd(B, compute_uv=False)
        for sig, u, v in rep_b.solutions:
            assert np.min(np.abs(s_true - sig)) < 1e-6
            r = np.linalg.norm(B @ v - sig * u) + \
                np.linalg.norm(B.conj().T @ u - sig * v)
            assert r < 1e-8 * np.linalg.norm(B)


class TestMeshMetrics:
    def test_collect_metrics_rows(self, mesh):
        """Mesh runs return the same stacked per-iteration metrics as the
        single-chip collect_metrics path (SURVEY §5.1/5.5 telemetry parity)."""
        A, b = _linear_problem(seed=13)
        s = maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b, initial_num_candidates=6)
        rep = s.evolve(max_iterations=10, collect_metrics=True)
        assert rep.metrics is not None
        energy = rep.metrics["landscape_energy"]
        assert energy.shape == (10,)
        # executed rows carry real values; rows past convergence are frozen
        assert np.all(np.isfinite(energy))
        assert rep.metrics["candidate_residuals"].shape[0] == 10

    def test_collect_metrics_with_checkpointing(self, mesh, tmp_path):
        A, b = _linear_problem(seed=14)
        path = str(tmp_path / "mm.npz")
        s = maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b, initial_num_candidates=6)
        rep = s.evolve(max_iterations=12, collect_metrics=True,
                       checkpoint_path=path, checkpoint_every=4)
        # rows cover executed chunks only (chunk granularity), each full
        rows = rep.metrics["landscape_energy"].shape[0]
        assert rows % 4 == 0 and 4 <= rows <= 12


class TestMeshSolverStaging:
    def test_swap_preserves_original_precision_planes(self, mesh):
        """MeshSolver must keep the split-f64 planes built from the USER's
        data across construction AND swaps: re-deriving them from the c64
        compute copy would make refinement certify the rounding instead of
        the original system (code-review r4 finding)."""
        from maus_tpu.core.types import SolverConfig

        rng = np.random.default_rng(11)
        n = 32
        A1 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        eps32 = float(np.finfo(np.float32).eps)
        cfg = SolverConfig(problem_type=ProblemType.EIGENVALUE,
                           num_candidates=8, tol=1e-8, dtype=jnp.complex64,
                           convergence_floor=50 * eps32)
        s = maus_tpu.MeshSolver(A1, ProblemType.EIGENVALUE, mesh, config=cfg)
        A_dev, A64 = s._stA
        assert A_dev.dtype == jnp.complex64
        # planes are EXACTLY the user's f64 data, not its c64 rounding
        np.testing.assert_array_equal(np.asarray(A64.re), A1.real)
        np.testing.assert_array_equal(np.asarray(A64.im), A1.imag)

        A2 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        s.update_problem(matrix=A2)
        np.testing.assert_array_equal(np.asarray(s._stA[1].re), A2.real)

    def test_stage_device_arrays(self, mesh):
        """stage_A / stage_b accept already-on-device complex arrays (one
        jitted derivation) and produce correct sharded planes."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from maus_tpu.parallel.dist_qr import stage_A, stage_b

        rng = np.random.default_rng(12)
        n = 32
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        A_dev0 = jax.device_put(jnp.asarray(A),
                                NamedSharding(mesh, P(None, "model")))
        b_dev0 = jnp.asarray(b)
        A_dev, Are, Aim = stage_A(mesh, A_dev0)
        b_dev, bre, bim = stage_b(mesh, b_dev0)
        np.testing.assert_allclose(np.asarray(Are), A.real, rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(bim), b.imag, rtol=0, atol=0)
        m = mesh.shape["model"]
        for s in Are.addressable_shards:
            assert s.data.shape == (n, n // m)


class TestMeshSolverUpdateProblem:
    def test_swap_solves_new_system(self, mesh):
        """Scenario-1 parity (AMS:645-652) on the mesh: swap the operand
        mid-run and the next evolve solves the NEW system."""
        n = 32
        A1, b1 = gen.dynamic_solve_system(n, t_step=0)
        A2, b2 = gen.dynamic_solve_system(n, t_step=25)
        s = maus_tpu.MeshSolver(A1, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b1, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        rep1 = s.evolve(max_iterations=30)
        assert rep1.converged
        x1 = rep1.solutions[0][0]
        assert np.linalg.norm(A1 @ x1 - b1) / np.linalg.norm(b1) <= 1e-8

        s.update_problem(matrix=A2, b_vector=b2)
        rep2 = s.evolve(max_iterations=30)
        assert rep2.converged
        x2 = rep2.solutions[0][0]
        assert np.linalg.norm(A2 @ x2 - b2) / np.linalg.norm(b2) <= 1e-8
        # the two systems genuinely differ — x1 does not satisfy system 2
        assert np.linalg.norm(A2 @ x1 - b2) / np.linalg.norm(b2) > 1e-6

    def test_swap_with_population_carryover(self, mesh, tmp_path):
        """The reference's swap continues the SAME population against the new
        operand (AMS:645-652). Mesh route: checkpoint the pre-swap run,
        resume post-swap — the restored candidates and their stale
        factorization iterate against the new system and still reach tol
        (the Ψ ladder refactors against the new operand on regression)."""
        n = 32
        A1, b1 = gen.dynamic_solve_system(n, t_step=0)
        A2, b2 = gen.dynamic_solve_system(n, t_step=1)   # nearby time step
        path = str(tmp_path / "swap_carry.npz")
        s = maus_tpu.MeshSolver(A1, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b1, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        rep_pre = s.evolve(max_iterations=4, checkpoint_path=path,
                           checkpoint_every=4)
        s.update_problem(matrix=A2, b_vector=b2)
        # MeshSolver reopens the restored carry automatically after a swap:
        # without it the stale convergence bookkeeping (the pre-swap run
        # already converged on system 1) would stop the loop at step zero
        rep = s.evolve(max_iterations=40, resume_from=path)
        assert rep.iterations > rep_pre.iterations   # continued, not stopped
        x = rep.solutions[0][0]
        assert np.linalg.norm(A2 @ x - b2) / np.linalg.norm(b2) <= 1e-8

    def test_post_swap_checkpoint_resume_stays_closed(self, mesh, tmp_path):
        """A checkpoint taken AFTER the swap belongs to the current operand:
        resuming it must NOT reopen (a spurious reopen would demote converged
        candidates and redo finished work — the advertised resume is
        bit-exact). The operand-epoch bookkeeping distinguishes it from a
        pre-swap checkpoint."""
        n = 32
        A1, b1 = gen.dynamic_solve_system(n, t_step=0)
        A2, b2 = gen.dynamic_solve_system(n, t_step=25)
        path = str(tmp_path / "post_swap.npz")
        s = maus_tpu.MeshSolver(A1, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b1, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        s.update_problem(matrix=A2, b_vector=b2)
        rep = s.evolve(max_iterations=30, checkpoint_path=path)
        assert rep.converged
        # same-epoch resume: the restored bookkeeping is honored — the run
        # stops on its carried convergence instead of re-iterating
        rep2 = s.evolve(max_iterations=60, resume_from=path)
        assert rep2.iterations == rep.iterations
        assert rep2.converged

    def test_pre_swap_resume_reopens_despite_interleaved_evolve(
            self, mesh, tmp_path):
        """A fresh (non-resuming) evolve between the swap and the resume must
        not consume the reopen: the pre-swap checkpoint still refers to the
        old operand and must be reopened when finally resumed."""
        n = 32
        A1, b1 = gen.dynamic_solve_system(n, t_step=0)
        A2, b2 = gen.dynamic_solve_system(n, t_step=25)
        path = str(tmp_path / "pre_swap.npz")
        s = maus_tpu.MeshSolver(A1, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b1, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        rep_pre = s.evolve(max_iterations=30, checkpoint_path=path)
        assert rep_pre.converged
        s.update_problem(matrix=A2, b_vector=b2)
        s.evolve(max_iterations=5)               # fresh run, no resume
        rep = s.evolve(max_iterations=60, resume_from=path)
        # reopened: the restored (converged-on-system-1) population iterated
        # again and solved system 2
        assert rep.iterations > rep_pre.iterations
        x = rep.solutions[0][0]
        assert np.linalg.norm(A2 @ x - b2) / np.linalg.norm(b2) <= 1e-8

    def test_noop_update_does_not_reopen(self, mesh, tmp_path):
        """update_problem() with nothing to stage is a no-op — it must not
        mark the operand as swapped (a later resume would spuriously
        reopen)."""
        n = 32
        A, b = _linear_problem(seed=5)
        path = str(tmp_path / "noop.npz")
        s = maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        rep = s.evolve(max_iterations=30, checkpoint_path=path)
        assert rep.converged
        s.update_problem()                       # no operands: no-op
        rep2 = s.evolve(max_iterations=60, resume_from=path)
        assert rep2.iterations == rep.iterations   # not reopened

    def test_explicit_reopen_override(self, mesh, tmp_path):
        """MausSolver.evolve parity: an explicit ``reopen=`` bool overrides
        the epoch-based auto decision."""
        n = 32
        A, b = _linear_problem(seed=6)
        path = str(tmp_path / "explicit.npz")
        s = maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b, initial_num_candidates=6,
                                global_convergence_tol=1e-8)
        rep = s.evolve(max_iterations=30, checkpoint_path=path)
        assert rep.converged
        # auto would NOT reopen here (same epoch); force it
        rep2 = s.evolve(max_iterations=60, resume_from=path, reopen=True)
        assert rep2.iterations > rep.iterations    # re-iterated
        assert rep2.converged

    def test_b_vector_rejected_for_spectral(self, mesh):
        rng = np.random.default_rng(11)
        n = 32
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        s = maus_tpu.MeshSolver(A, ProblemType.EIGENVALUE, mesh,
                                initial_num_candidates=8)
        with pytest.raises(ValueError, match="b_vector"):
            s.update_problem(b_vector=np.ones(n))

    def test_b_only_swap(self, mesh):
        n = 32
        A, b1 = gen.dynamic_solve_system(n, t_step=0)
        rng = np.random.default_rng(9)
        b2 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        s = maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, mesh,
                                b_vector=b1, initial_num_candidates=6)
        s.update_problem(b_vector=b2)
        rep = s.evolve(max_iterations=30)
        x = rep.solutions[0][0]
        assert np.linalg.norm(A @ x - b2) / np.linalg.norm(b2) <= 1e-8

    def test_requires_model_axis(self):
        A, b = _linear_problem()
        single = Mesh(np.array(jax.devices()[:1]).reshape(1), ("model",))
        with pytest.raises(ValueError, match="model"):
            maus_tpu.MeshSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, single,
                                b_vector=b)

    def test_eig_mesh_solver(self, mesh):
        rng = np.random.default_rng(10)
        n = 32
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        s = maus_tpu.MeshSolver(A, ProblemType.EIGENVALUE, mesh,
                                initial_num_candidates=8)
        rep = s.evolve(max_iterations=30)
        assert rep.num_distinct >= 1
        lam_true = np.linalg.eigvals(A)
        for lam, v in rep.solutions:
            assert np.min(np.abs(lam_true - lam)) < 1e-6
