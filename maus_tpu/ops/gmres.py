"""Batched restarted GMRES with Jacobi preconditioning.

The reference's iterative path (``spla.gmres(tol=1e-8, maxiter=50, M=Jacobi)``,
AMS:60-90) is dead code on modern SciPy (the removed ``tol`` kwarg raises TypeError,
swallowed at AMS:98 — SURVEY.md §0.1); this module implements the *intended*
capability natively:

* **Batched over candidates**: one Arnoldi iteration for all K candidates is a single
  ``(K, m+1, N) × (K, N)`` contraction plus one batched matvec — batched work
  instead of K sequential scipy calls.
* **Matrix-free**: the operator is a closure, so eigen-shifted systems
  ``(A − λ_k I + Ψ_k D) w = v_k`` never materialize K copies of A (the direct path in
  :mod:`maus_tpu.ops.batched_solve` must; this is the large-N escape hatch).
* **Jacobi preconditioning** (AMS:64-87): left preconditioning by ``1/diag(H_k)``
  with the reference's finiteness + magnitude>1e-12 guards.
* Fixed-shape Arnoldi basis (m = restart length) with masked classical Gram-Schmidt
  re-orthogonalization; restarts via ``lax.while_loop``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class GMRESResult(NamedTuple):
    x: jax.Array          # (K, N) solution iterates
    rel_residual: jax.Array   # (K,) preconditioned relative residual
    iterations: jax.Array     # (K,) int32 PER-CANDIDATE inner iterations: a
                              # candidate stops accumulating once it meets tol
                              # (the reference reports scipy's per-system count)
    converged: jax.Array      # (K,) bool


def jacobi_from_diag(diag: jax.Array) -> jax.Array:
    """Safe inverse-diagonal preconditioner (reference guards AMS:64-87):
    entries that are non-finite or smaller than 1e-12 in magnitude fall back to 1."""
    mag = jnp.abs(diag)
    ok = jnp.isfinite(mag) & (mag > 1e-12)
    safe = jnp.where(ok, diag, jnp.ones_like(diag))
    return jnp.where(ok, 1.0 / safe, jnp.ones_like(diag))


def _cdot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Conjugated inner product along the last axis."""
    return jnp.sum(jnp.conj(a) * b, axis=-1)


@partial(jax.jit, static_argnames=("matvec", "restart", "max_restarts"))
def gmres_batched(matvec: Callable[[jax.Array], jax.Array],
                  b: jax.Array,
                  x0: jax.Array | None = None,
                  *,
                  precond_diag: jax.Array | None = None,
                  tol: float | jax.Array = 1e-8,
                  restart: int = 32,
                  max_restarts: int = 8) -> GMRESResult:
    """Solve ``A_k x_k = b_k`` for K systems at once.

    Args:
      matvec: batched operator, maps ``(K, N) → (K, N)`` (row k applies A_k).
      b: ``(K, N)`` right-hand sides.
      x0: optional ``(K, N)`` initial guesses (reference seeds with b, AMS:61).
      precond_diag: optional ``(K, N)`` inverse-diagonal (apply :func:`jacobi_from_diag`
        to raw diagonals first).
      tol: scalar relative tolerance on the preconditioned residual.
      restart: Arnoldi subspace size m (GMRES(m)).
      max_restarts: outer restart cap; total inner iterations ≤ restart·max_restarts
        (reference: maxiter=50, AMS:89).
    """
    K, N = b.shape
    dtype = b.dtype
    m = restart
    # full-precision products (a TF32 default loses ~4 digits; Arnoldi dies
    # at that)
    with jax.default_matmul_precision("highest"):
        return _gmres_impl(matvec, b, x0, precond_diag, tol, m, max_restarts)


def _gmres_impl(matvec, b, x0, precond_diag, tol, m, max_restarts):
    K, N = b.shape
    dtype = b.dtype
    if x0 is None:
        x0 = b  # reference's warm start (AMS:61)
    Minv = precond_diag if precond_diag is not None else jnp.ones_like(b)

    def apply_M(r):
        return Minv * r

    bnorm = jnp.linalg.norm(apply_M(b), axis=-1)
    bnorm = jnp.maximum(bnorm, jnp.finfo(bnorm.dtype).tiny)

    def arnoldi_cycle(x):
        """One GMRES(m) cycle from iterate x. Returns (x_new, rel_res)."""
        r = apply_M(b - matvec(x))
        beta = jnp.linalg.norm(r, axis=-1)                      # (K,)
        beta_safe = jnp.maximum(beta, jnp.finfo(beta.dtype).tiny)
        V = jnp.zeros((K, m + 1, N), dtype)
        V = V.at[:, 0].set(r / beta_safe[:, None])
        H = jnp.zeros((K, m + 1, m), dtype)

        def step(j, carry):
            V, H = carry
            w = apply_M(matvec(V[:, j]))                        # (K, N)
            # classical Gram-Schmidt against slots 0..j (masked), twice (CGS2)
            slot_mask = (jnp.arange(m + 1) <= j)[None, :]       # (1, m+1)
            for _ in range(2):
                h = _cdot(V, w[:, None, :])                     # (K, m+1)
                h = jnp.where(slot_mask, h, 0.0)
                w = w - jnp.einsum("ks,ksn->kn", h, V)
                H = H.at[:, :, j].add(h)
            hnorm = jnp.linalg.norm(w, axis=-1)                 # (K,)
            H = H.at[:, j + 1, j].set(hnorm.astype(dtype))
            hsafe = jnp.maximum(hnorm, jnp.finfo(hnorm.dtype).tiny)
            V = V.at[:, j + 1].set(w / hsafe[:, None])
            return V, H

        V, H = jax.lax.fori_loop(0, m, step, (V, H))

        # least squares: y = argmin ‖β e1 − H̄ y‖ per candidate, H̄: (m+1, m).
        e1 = jnp.zeros((K, m + 1), dtype).at[:, 0].set(beta.astype(dtype))

        def lstsq_one(Hk, e1k):
            Q, R = jnp.linalg.qr(Hk, mode="reduced")            # (m+1,m), (m,m)
            rhs = jnp.conj(Q.T) @ e1k
            # guard singular R (happens on lucky breakdown): Tikhonov-damp
            eps = jnp.asarray(1e-30, R.real.dtype)
            Rd = R + eps * jnp.eye(m, dtype=R.dtype)
            y = jax.scipy.linalg.solve_triangular(Rd, rhs, lower=False)
            return y

        y = jax.vmap(lstsq_one)(H, e1)                          # (K, m)
        dx = jnp.einsum("km,kmn->kn", y, V[:, :m])
        x_new = x + dx
        rel = jnp.linalg.norm(apply_M(b - matvec(x_new)), axis=-1) / bnorm
        finite = jnp.all(jnp.isfinite(x_new.real) &
                         (jnp.isfinite(x_new.imag) if jnp.iscomplexobj(x_new)
                          else jnp.ones_like(x_new.real, bool)), axis=-1)
        x_new = jnp.where(finite[:, None], x_new, x)
        rel = jnp.where(finite, rel, jnp.inf)
        return x_new, rel

    def cond(carry):
        x, rel, it, _ = carry
        return (it < max_restarts) & jnp.any(rel > tol)

    def body(carry):
        x, rel, it, iters_k = carry
        x_new, rel_new = arnoldi_cycle(x)
        # keep candidates that already met tol untouched (and stop counting
        # their work — per-candidate true iteration counts)
        keep = rel <= tol
        x_out = jnp.where(keep[:, None], x, x_new)
        rel_out = jnp.where(keep, rel, rel_new)
        iters_out = jnp.where(keep, iters_k, iters_k + m)
        return x_out, rel_out, it + 1, iters_out

    rel0 = jnp.linalg.norm(apply_M(b - matvec(x0)), axis=-1) / bnorm
    x, rel, _, iters = jax.lax.while_loop(
        cond, body, (x0, rel0, jnp.asarray(0, jnp.int32),
                     jnp.zeros((K,), jnp.int32)))
    return GMRESResult(x=x, rel_residual=rel, iterations=iters, converged=rel <= tol)
