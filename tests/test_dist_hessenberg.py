"""Distributed (column-sharded) Hessenberg reduction, shifted solves, and the
distributed eig entry point on the 8-device CPU mesh — the eig-path
counterpart of test_dist_qr.py.

The compute dtype is complex64 where the GPU path is exercised; reduction /
solve identities are also checked in complex128 against host LAPACK oracles.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from maus_tpu.parallel import mesh as mesh_mod
from maus_tpu.parallel.dist_hessenberg import (dist_hess_solve,
                                               dist_hessenberg,
                                               eig_distributed)

N = 64
M_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < M_DEV:
        pytest.skip("needs 8 devices")
    return mesh_mod.make_mesh(replica=1, model=M_DEV)


def _matrix(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))


def _place(mesh, A, dtype=jnp.complex128):
    return jax.device_put(jnp.asarray(A, dtype),
                          NamedSharding(mesh, P(None, "model")))


class TestDistHessenberg:
    def test_reduction_identities(self, mesh):
        """H upper-Hessenberg, Q unitary, A = Q H Qᴴ — all to c128 precision."""
        A = _matrix(0)
        hess = dist_hessenberg(mesh, _place(mesh, A))
        H = np.asarray(hess.h)
        Q = np.asarray(hess.q)
        assert np.abs(np.tril(H, -2)).max() == 0.0
        assert np.abs(Q.conj().T @ Q - np.eye(N)).max() < 1e-12
        rel = np.linalg.norm(Q @ H @ Q.conj().T - A) / np.linalg.norm(A)
        assert rel < 1e-13

    def test_matches_single_chip_reduction(self, mesh):
        """Same Householder chain as ops.hessenberg.reduce_hessenberg — the
        sharded H must agree with the single-device H (same sign choices)."""
        from maus_tpu.ops.hessenberg import reduce_hessenberg

        A = _matrix(1)
        H_dist = np.asarray(dist_hessenberg(mesh, _place(mesh, A)).h)
        H_one = np.asarray(reduce_hessenberg(jnp.asarray(A)).h)
        assert np.linalg.norm(H_dist - H_one) / np.linalg.norm(H_one) < 1e-12

    def test_per_device_memory_is_sharded(self, mesh):
        """The factors actually shard: each device holds 1/m of H and Q."""
        A = _matrix(2)
        hess = dist_hessenberg(mesh, _place(mesh, A))
        shard = hess.h.addressable_shards[0]
        assert shard.data.shape == (N, N // M_DEV)
        assert len(hess.h.addressable_shards) == M_DEV

    def test_shifted_solve_oracle(self, mesh):
        """(H − λI + ψI) w = b against dense LAPACK, per candidate."""
        A = _matrix(3)
        hess = dist_hessenberg(mesh, _place(mesh, A))
        H = np.asarray(hess.h)
        rng = np.random.default_rng(7)
        K = 8
        lams = rng.standard_normal(K) + 1j * rng.standard_normal(K)
        B = rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))
        psi = np.full((K,), 1e-6)
        W = np.asarray(dist_hess_solve(mesh, hess.h, jnp.asarray(lams),
                                       jnp.asarray(B),
                                       psi=jnp.asarray(psi)))
        for k in range(K):
            M = H - lams[k] * np.eye(N) + psi[k] * np.eye(N)
            w_ref = np.linalg.solve(M, B[k])
            err = np.linalg.norm(W[k] - w_ref) / np.linalg.norm(w_ref)
            assert err < 1e-10, (k, err)

    def test_shifted_solve_c64(self, mesh):
        """The GPU dtype path: c64 factors, c64 rhs, ~1e-5 accuracy."""
        A = _matrix(4)
        hess = dist_hessenberg(mesh, _place(mesh, A, jnp.complex64))
        H = np.asarray(hess.h, dtype=np.complex128)
        rng = np.random.default_rng(8)
        K = 4
        lams = (rng.standard_normal(K) + 1j * rng.standard_normal(K))
        B = rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))
        W = np.asarray(dist_hess_solve(
            mesh, hess.h, jnp.asarray(lams, jnp.complex64),
            jnp.asarray(B, jnp.complex64)))
        for k in range(K):
            w_ref = np.linalg.solve(H - lams[k] * np.eye(N), B[k])
            err = np.linalg.norm(W[k] - w_ref) / np.linalg.norm(w_ref)
            assert err < 1e-4, (k, err)


class TestEigDistributed:
    def test_finds_eigenpairs(self, mesh):
        A = _matrix(5)
        lam, X, res = eig_distributed(mesh, A, num_candidates=8,
                                      iterations=25, seed=0)
        anorm = np.linalg.norm(A) / np.sqrt(N)
        good = res < 1e-10 * anorm
        assert good.sum() >= 6
        ev = np.linalg.eigvals(A)
        dist = np.abs(lam[good][:, None] - ev[None, :]).min(axis=1)
        assert dist.max() < 1e-8
        # eigenvector residual against A directly
        for i in np.nonzero(good)[0][:3]:
            r = np.linalg.norm(A @ X[i] - lam[i] * X[i])
            assert r < 1e-10 * anorm

    def test_api_mesh_router(self, mesh):
        """maus_tpu.eig(A, mesh=mesh) routes to the distributed path and
        reports distinct converged eigenpairs."""
        import maus_tpu

        A = _matrix(6)
        rep = maus_tpu.eig(A, tol=1e-9, max_iterations=25,
                           num_candidates=8, mesh=mesh)
        assert rep.num_distinct >= 5
        for (lam_i, x_i), r_i in zip(rep.solutions, rep.residuals):
            assert np.linalg.norm(A @ x_i - lam_i * x_i) < 1e-6
