"""Batched Lanczos — the device equivalent of the reference's ARPACK ``eigsh`` call
on the sparse-Hermitian fast path (AMS:186-210: ``spla.eigsh(k≤6, which='LM',
v0=candidate_vector)``).

ARPACK's implicitly-restarted Lanczos is sequential Fortran; on the device the
right shape is a fixed-m Krylov build with **full reorthogonalization**
(numerically robust, and the m×m Gram work is GEMM-shaped), batched over candidates via
``vmap`` — every candidate brings its own start vector ``v0`` exactly as the
reference seeds ARPACK per candidate. The small (m, m) tridiagonal eigenproblem
is solved with XLA's ``eigh``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LanczosResult(NamedTuple):
    eigenvalues: jax.Array     # (K, k) Ritz values (ascending)
    eigenvectors: jax.Array    # (K, k, N) Ritz vectors
    residuals: jax.Array       # (K, k) ‖A y − θ y‖ per Ritz pair


def _lanczos_single(matvec, v0: jax.Array, m: int):
    """m-step Lanczos with full reorthogonalization from start vector v0.

    Returns (V, alpha, beta): V (m, N) orthonormal basis, alpha (m,) real
    diagonal, beta (m-1,) real off-diagonal.
    """
    n = v0.shape[0]
    dtype = v0.dtype
    rdt = jnp.float32 if dtype in (jnp.complex64, jnp.float32) else jnp.float64
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), jnp.finfo(rdt).tiny)

    V0 = jnp.zeros((m, n), dtype).at[0].set(v0)
    alpha0 = jnp.zeros((m,), rdt)
    beta0 = jnp.zeros((m,), rdt)

    def step(j, carry):
        V, alpha, beta = carry
        v = V[j]
        w = matvec(v)
        a = jnp.real(jnp.sum(jnp.conj(v) * w))
        alpha = alpha.at[j].set(a.astype(rdt))
        w = w - a.astype(dtype) * v
        # full reorthogonalization against all built vectors (twice — CGS2)
        mask = (jnp.arange(m) <= j)[:, None]
        for _ in range(2):
            coeff = jnp.sum(jnp.conj(V) * w[None, :], axis=1)      # (m,)
            w = w - jnp.sum(jnp.where(mask, coeff[:, None] * V, 0), axis=0)
        nb = jnp.linalg.norm(w)
        beta = beta.at[j].set(nb.astype(rdt))
        w_next = jnp.where(nb > 1e-12, w / jnp.maximum(nb, jnp.finfo(rdt).tiny),
                           jnp.zeros_like(w))
        V = jax.lax.cond(j + 1 < m, lambda V: V.at[j + 1].set(w_next),
                         lambda V: V, V)
        return V, alpha, beta

    return jax.lax.fori_loop(0, m, step, (V0, alpha0, beta0))


@partial(jax.jit, static_argnames=("k", "m"))
def lanczos_batched(A: jax.Array, V0: jax.Array, k: int = 6,
                    m: int = 24) -> LanczosResult:
    """Largest-magnitude ``k`` eigenpairs of Hermitian A for each start vector.

    Args:
      A: (N, N) Hermitian.
      V0: (K, N) start vectors (reference: each candidate's own v_k, AMS:194).
      k: Ritz pairs to return (reference k = min(6, N−1)).
      m: Krylov subspace size (≥ k; more → better interior convergence).
    """
    with jax.default_matmul_precision("highest"):
        return _lanczos_impl(A, V0, k, m)


def _lanczos_impl(A, V0, k, m):
    def one(v0):
        V, alpha, beta = _lanczos_single(lambda x: A @ x, v0, m)
        T = jnp.diag(alpha) + jnp.diag(beta[:-1], 1) + jnp.diag(beta[:-1], -1)
        theta, S = jnp.linalg.eigh(T)                    # ascending
        # largest magnitude k (reference which='LM', AMS:194)
        order = jnp.argsort(-jnp.abs(theta))[:k]
        theta_k = theta[order]
        Y = (S[:, order].astype(V.dtype).T @ V)          # (k, N) Ritz vectors
        Y = Y / jnp.maximum(jnp.linalg.norm(Y, axis=1, keepdims=True), 1e-30)
        resid = jnp.linalg.norm(Y @ A.T - theta_k[:, None].astype(V.dtype) * Y,
                                axis=1)
        return theta_k, Y, resid.astype(jnp.float32)

    theta, Y, resid = jax.vmap(one)(V0)
    return LanczosResult(eigenvalues=theta, eigenvectors=Y, residuals=resid)
