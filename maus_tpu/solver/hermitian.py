"""Hermitian eigenproblem fast path.

Reference behavior (AMS:154-221): when the matrix is Hermitian, *every candidate,
every iteration* runs a full ``sla.eigh(A)`` (O(N³) × K × iters!) and snaps to the
eigenpair most similar to its own vector. Because its init vectors are non-zero-mean
the whole population snaps onto 1-2 low-frequency eigenpairs (SURVEY.md §0.1 —
measured 2/8 coverage forever).

Device-native rebuild:

* ONE shared ``jnp.linalg.eigh`` at setup (XLA batched QR/eigh on device);
* per-candidate snap = one (K, N) × (N, N) similarity GEMM + masked argmax;
* **coverage guarantee**: eigenpairs already claimed by a converged leader are
  masked out of the snap, so respawned candidates land on *unclaimed* eigenpairs —
  the population covers all N eigenpairs in ⌈N/K⌉ rounds instead of stalling at 2.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import (CandidateStatus, Population, SolverConfig, StrategyState)
from .candidate import StepStats


class EighCache(NamedTuple):
    """Shared spectral decomposition of the Hermitian operand."""

    w: jax.Array    # (N,) real eigenvalues, ascending
    V: jax.Array    # (N, N) eigenvectors in columns


def eigh_setup(A: jax.Array) -> EighCache:
    with jax.default_matmul_precision("highest"):
        w, V = jnp.linalg.eigh(A)
    return EighCache(w=w, V=V)


def step_hermitian(cfg: SolverConfig, A: jax.Array, cache: EighCache,
                   pop: Population, strat: StrategyState
                   ) -> tuple[Population, StepStats]:
    """Snap every active candidate to its best *unclaimed* eigenpair."""
    N = cache.w.shape[0]
    conv = pop.status == CandidateStatus.CONVERGED
    retired = pop.status == CandidateStatus.RETIRED
    active = ~conv & ~retired

    # which eigenpair each converged candidate owns: nearest eigenvalue index
    dist = jnp.abs(pop.lam.real[:, None] - cache.w[None, :])      # (K, N)
    owned_idx = jnp.argmin(dist, axis=-1)                         # (K,)
    claimed = jnp.zeros((N,), bool).at[owned_idx].max(conv)       # (N,) any conv owner

    # similarity of each candidate vector to each eigenvector (AMS:165-173)
    overlap = jnp.abs(pop.v @ jnp.conj(cache.V))                  # (K, N)
    overlap = jnp.where(claimed[None, :], -jnp.inf, overlap)
    snap = jnp.argmax(overlap, axis=-1)                           # (K,)
    any_unclaimed = jnp.any(~claimed)

    v_new = cache.V.T[snap]                                       # (K, N) row k = e_snap
    lam_new = cache.w[snap].astype(cfg.dtype)

    # residual of the snapped pair vs the original matrix (≈ machine eps)
    Av = v_new @ A.T
    resid = jnp.linalg.norm(Av - lam_new[:, None] * v_new, axis=-1) \
        .astype(cfg.real_dtype)
    # convergence floor scales with ‖A‖ — eig residuals are absolute (AMS:297)
    anorm = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(N)))).real \
        .astype(cfg.real_dtype)
    # both terms scale with the eig residual's units (see candidate.py's
    # _adapt_and_classify note on absolute thresholds)
    thresh_eff = jnp.maximum(strat.threshold, cfg.convergence_floor) * anorm

    take = active & any_unclaimed
    pop = dataclasses.replace(
        pop,
        v=jnp.where(take[:, None], v_new, pop.v),
        lam=jnp.where(take, lam_new, pop.lam),
        residual=jnp.where(take, resid, pop.residual),
        prev_residual=jnp.where(take, pop.residual, pop.prev_residual),
        weight=jnp.where(take, 1.0, pop.weight),
        stuck=jnp.where(take, 0, pop.stuck),
        status=jnp.where(take & (resid < thresh_eff),
                         jnp.int8(CandidateStatus.CONVERGED),
                         jnp.where(take, jnp.int8(CandidateStatus.REFINING),
                                   pop.status)))
    return pop, StepStats(solve_fail_frac=jnp.asarray(0.0, jnp.float32),
                          psi_attempts_mean=jnp.asarray(0.0, jnp.float32),
                          regress_frac=jnp.asarray(0.0, jnp.float32))


# ---------------------------------------------------------------------------
# Large-N / sparse-input path: per-candidate Lanczos (reference AMS:186-210)
# ---------------------------------------------------------------------------

def step_hermitian_lanczos(cfg: SolverConfig, A: jax.Array, pop: Population,
                           strat: StrategyState, k: int = 6, m: int = 32
                           ) -> tuple[Population, StepStats]:
    """Krylov variant of the fast path for operands where a full eigh is
    disproportionate (the reference's sparse branch calls ARPACK ``eigsh(k≤6,
    v0=candidate)``, AMS:186-210).

    Each candidate runs an m-step batched Lanczos seeded from its own vector,
    **deflated against the eigenvectors already claimed** by converged candidates
    — so successive respawn waves converge to successive unclaimed extremal
    eigenpairs instead of re-finding the dominant ones (Lanczos with a deflated
    start vector never re-enters the deflated subspace, up to rounding that the
    next wave's deflation re-removes).
    """
    from ..ops.lanczos import lanczos_batched

    N = A.shape[0]
    k = min(k, N - 1)
    conv = pop.status == CandidateStatus.CONVERGED
    retired = pop.status == CandidateStatus.RETIRED
    active = ~conv & ~retired

    # deflate start vectors against claimed (converged) eigenvectors
    Vc = pop.v * conv.astype(cfg.dtype)[:, None]
    coeff = jnp.conj(Vc) @ pop.v.T                              # (K, K)
    v0 = pop.v - coeff.T @ Vc
    norms = jnp.linalg.norm(v0, axis=-1, keepdims=True)
    v0 = jnp.where(norms > 1e-6, v0 / jnp.maximum(norms, 1e-30), pop.v)

    res = lanczos_batched(A, v0, k=k, m=m)

    # a Ritz pair is 'claimed' if a converged candidate already owns that
    # eigenvalue (same similarity rule as dedup, AMS:435-437)
    lam_conv = jnp.where(conv, pop.lam.real, jnp.inf)           # (K,)
    dist = jnp.abs(res.eigenvalues[:, :, None] - lam_conv[None, None, :])
    tol_eff = cfg.lambda_similarity_tol + jnp.abs(res.eigenvalues)[:, :, None] \
        * 1e-6
    is_claimed = jnp.any(dist < tol_eff, axis=-1)               # (K, k)

    # pick the best unclaimed Ritz pair per candidate (lowest residual)
    score = res.residuals + jnp.where(is_claimed, 1e30, 0.0)
    pick = jnp.argmin(score, axis=-1)                            # (K,)
    rows = jnp.arange(pop.capacity)
    v_new = res.eigenvectors[rows, pick]                         # (K, N)
    lam_new = res.eigenvalues[rows, pick].astype(cfg.dtype)
    resid_new = res.residuals[rows, pick].astype(cfg.real_dtype)
    any_unclaimed = jnp.any(~is_claimed, axis=-1)                # (K,)

    take = active & any_unclaimed & jnp.isfinite(resid_new)
    anorm = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(N)))).real \
        .astype(cfg.real_dtype)
    good = take & (resid_new < jnp.maximum(strat.threshold,
                                           cfg.convergence_floor) * anorm)
    pop = dataclasses.replace(
        pop,
        v=jnp.where(take[:, None], v_new, pop.v),
        lam=jnp.where(take, lam_new, pop.lam),
        residual=jnp.where(take, resid_new, pop.residual),
        prev_residual=jnp.where(take, pop.residual, pop.prev_residual),
        weight=jnp.where(good, 1.0, pop.weight),
        stuck=jnp.where(good, 0, pop.stuck),
        status=jnp.where(good, jnp.int8(CandidateStatus.CONVERGED),
                         jnp.where(take, jnp.int8(CandidateStatus.REFINING),
                                   pop.status)))
    return pop, StepStats(solve_fail_frac=jnp.asarray(0.0, jnp.float32),
                          psi_attempts_mean=jnp.asarray(0.0, jnp.float32),
                          regress_frac=jnp.asarray(0.0, jnp.float32))
