"""Distributed QR factorization + solve (VERDICT r1 #3) on the 8-device CPU
mesh. The compute dtype is deliberately complex64 (the GPU path); oracles are
f64 host LAPACK."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from maus_tpu.parallel import mesh as mesh_mod
from maus_tpu.parallel.dist_qr import (DistQR, dist_qr, dist_qr_solve,
                                       solve_distributed)
from jax.sharding import NamedSharding, PartitionSpec as P

N = 256
M_DEV = 8
BLOCK = 32


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < M_DEV:
        pytest.skip("needs 8 devices")
    return mesh_mod.make_mesh(replica=1, model=M_DEV)


def _problem(seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))
    q2, _ = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))
    s = np.logspace(0, -np.log10(cond), N)
    A = (q1 * s[None, :]) @ q2.conj().T
    b = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    return A, b


def _place(mesh, A):
    return jax.device_put(jnp.asarray(A, jnp.complex64),
                          NamedSharding(mesh, P(None, "model")))


class TestDistQR:
    def test_factors_reproduce_operand(self, mesh):
        A, _ = _problem(seed=0)
        fac = dist_qr(mesh, _place(mesh, A), block=BLOCK)
        Q = np.asarray(fac.q, dtype=np.complex128)
        R = np.asarray(fac.r, dtype=np.complex128)
        rel = np.linalg.norm(Q @ R - A) / np.linalg.norm(A)
        assert rel < 5e-6                  # c64 factorization accuracy
        orth = np.linalg.norm(Q.conj().T @ Q - np.eye(N))
        assert orth < 5e-5                 # CGS2 orthogonality
        assert np.linalg.norm(np.tril(R, -1)) < 1e-6 * np.linalg.norm(R)

    def test_factors_are_column_sharded(self, mesh):
        """Memory scaling: every factor shard is (N, N/m) — no replication."""
        A, _ = _problem(seed=1)
        fac = dist_qr(mesh, _place(mesh, A), block=BLOCK)
        for arr in (fac.q, fac.r):
            shapes = {s.data.shape for s in arr.addressable_shards}
            assert shapes == {(N, N // M_DEV)}

    def test_solve_matches_dense_oracle(self, mesh):
        A, b = _problem(seed=2)
        fac = dist_qr(mesh, _place(mesh, A), block=BLOCK)
        x = dist_qr_solve(mesh, fac, jnp.asarray(b, jnp.complex64),
                          block=BLOCK)
        x_true = np.linalg.solve(A, b)
        rel = np.linalg.norm(np.asarray(x, np.complex128) - x_true) \
            / np.linalg.norm(x_true)
        assert rel < 1e-4                  # c64 before refinement


class TestSolveDistributed:
    def test_refined_solve_reaches_1e8(self, mesh):
        """VERDICT #3 'done' criterion: sharded-QR solve == dense oracle to
        1e-8 (split-f64 refinement against the sharded factors)."""
        A, b = _problem(seed=3, cond=1e3)
        xre, xim, rel = solve_distributed(mesh, A, b, tol=1e-9, block=BLOCK)
        assert float(rel) < 1e-9
        x = np.asarray(xre, np.float64) + 1j * np.asarray(xim, np.float64)
        resid = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert resid < 1e-8


class TestApiMeshRouting:
    def test_solve_with_mesh_routes_distributed(self, mesh):
        """maus_tpu.solve(A, b, mesh=...) reaches 1e-8 via the distributed QR
        (STATUS gap 4)."""
        import maus_tpu

        A, b = _problem(seed=5, cond=100.0)
        rep = maus_tpu.solve(A, b, tol=1e-9, mesh=mesh)
        assert rep.converged
        x = rep.solutions[0][0]
        rel = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert rel < 1e-8


class TestDistributedEvolve:
    """The FULL population meta-heuristic over a mesh-sharded factorization
    (STATUS round-2 gap 4): evolve's carry holds the column-sharded DistQR,
    candidate solves go through dist_qr_solve, refinement reuses the factors."""

    def test_population_evolve_with_sharded_factorization(self, mesh):
        import maus_tpu

        A, b = _problem(seed=3, cond=1e6)
        rep = maus_tpu.solve(A, b, tol=1e-8, max_iterations=40,
                             num_candidates=8, mesh=mesh)
        assert rep.converged
        assert rep.iterations > 0          # the evolve loop actually ran
        x = rep.solutions[0][0]
        rel = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
        assert rel <= 1e-8

    def test_carry_factor_is_sharded(self, mesh):
        """The factorization inside the evolve carry is genuinely
        column-sharded: per-device shard is 1/m of each factor."""
        import jax.numpy as jnp

        from maus_tpu.core.types import (ProblemKnowledge, ProblemType,
                                         SolverConfig)
        from maus_tpu.parallel.dist_qr import DistQR
        from maus_tpu.solver import evolve as ev

        A, b = _problem(seed=4)
        Ad = _place(mesh, A)
        bd = jnp.asarray(b, jnp.complex64)
        cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=8, tol=1e-6, dtype=jnp.complex64,
                           convergence_floor=1e-5, refine=False)
        kn = ProblemKnowledge(shape=(N, N))
        carry = ev.init_carry(cfg, kn, Ad, jax.random.PRNGKey(0), mesh=mesh,
                              dist_block=BLOCK)
        assert isinstance(carry.fac, DistQR)
        assert carry.fac.q.addressable_shards[0].data.shape == (N, N // M_DEV)
        carry2, _ = ev.evolve_while(cfg, kn, Ad, bd, jax.random.PRNGKey(0),
                                    3, 1, mesh=mesh, dist_block=BLOCK)
        assert carry2.fac.q.addressable_shards[0].data.shape == \
            (N, N // M_DEV)
        assert bool(jnp.isfinite(carry2.best_residual))
