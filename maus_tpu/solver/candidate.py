"""Batched candidate update steps — the vmapped rebuild of the reference's
``SolutionCandidate.update_solution_step`` (AMS:145-331).

One call here advances *all* K candidates: the reference's per-candidate Python loop
(AMS:574-576) becomes one batched device program per iteration. All branching
(solve success/failure, stuck/retire, convergence) is masked arithmetic on the
:class:`~maus_tpu.core.types.Population` SoA.

Key deliberate deviations from the reference, per SURVEY.md §0.1:

* zero-mean Gaussian init (reference's U[0,1] init collapses diversity, AMS:130);
* step-size gains that can actually reach tolerance (reference α₀=0.01 with ×1.1
  growth provably stalls, AMS:17/307-316);
* the SVD population runs as a Rayleigh–Ritz block by default (distinct
  triplets by construction; the reference's candidates all crowd σ₁) and the
  Hermitian/eig paths deflate respawns against claimed solutions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.types import (CandidateStatus, Population, ProblemType, SolverConfig,
                          SolverPreference, StrategyState)
from ..ops.batched_solve import (CholFactors, LUFactors, QRFactors,
                                 batched_shifted_solve, solve_chol,
                                 solve_factored, solve_qr)
from ..ops.gmres import gmres_batched, jacobi_from_diag


# Eigen shift locking (step_eigen): a candidate keeps its carried (diverse)
# shift until its eigenresidual drops below this fraction of the operand's
# ‖A‖_F/√N scale, then switches to the Rayleigh quotient (RQI). A random unit
# vector sits at residual ≈ 1·scale; 0.1 ⇔ the iterate is ~90% one eigenvector.
_SHIFT_LOCK_FRAC = 0.1


class StepStats(NamedTuple):
    """Per-iteration step diagnostics consumed by the strategy layer."""

    solve_fail_frac: jax.Array    # fraction of active candidates whose solve failed
    psi_attempts_mean: jax.Array  # mean Ψ-ladder depth used this step
    regress_frac: jax.Array       # fraction of active candidates whose residual
                                  # regressed (> regress_ratio × previous)


def _regressed_mask(cfg: SolverConfig, prev: jax.Array,
                    new_residual: jax.Array, floor_scale=1.0) -> jax.Array:
    """ONE regression predicate (AMS:310-312) for the per-candidate dynamics
    and the population statistic. The near-floor gate is RELATIVE to the
    problem's residual scale (1 for linear — already relative; ‖A‖-scale for
    eig/SVD absolute residuals): the reference's absolute 1e-5 silently
    disabled stuck/α-shrink dynamics for small-norm operands."""
    return (new_residual > cfg.regress_ratio * prev) & \
        (prev > 1e-5 * floor_scale) & jnp.isfinite(prev)


def _regress_frac(cfg: SolverConfig, pop_before: Population,
                  new_residual: jax.Array, frozen: jax.Array,
                  floor_scale=1.0) -> jax.Array:
    regressed = _regressed_mask(cfg, pop_before.residual, new_residual,
                                floor_scale)
    active_f = (~frozen).astype(jnp.float32)
    nact = jnp.maximum(active_f.sum(), 1.0)
    return (regressed.astype(jnp.float32) * active_f).sum() / nact


# ---------------------------------------------------------------------------
# Initialization (reference M4a, AMS:129-143 — zero-mean here)
# ---------------------------------------------------------------------------

def init_population(cfg: SolverConfig, key: jax.Array, shape: tuple,
                    lam_scale=1.0, lam_center=0.0) -> Population:
    m, n = (int(shape[0]), int(shape[1]) if len(shape) > 1 else int(shape[0]))
    K = cfg.num_candidates
    keys = rng.make_candidate_keys(key, K)
    keys, use = rng.split_batch(keys)
    v = rng.normal_like_batch(use, (n,), cfg.dtype)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    u = None
    lam = jnp.zeros((K,), cfg.dtype)
    keys, use = rng.split_batch(keys)
    if cfg.problem_type == ProblemType.EIGENVALUE:
        # Random shifts matched to the spectrum's first two moments. The
        # reference draws from a FIXED ±2.5 window (AMS:134-135), which misses
        # the spectrum of any matrix whose eigenvalues live elsewhere; here
        # center = tr(A)/N (the exact spectral centroid) and the spread follows
        # from ‖A‖_F² = Σ|λ|² + (non-normality), so √(‖A‖_F²/N − |c|²) bounds
        # the RMS eigenvalue distance from the centroid.
        lam = (rng.normal_like_batch(use, (), cfg.dtype) * lam_scale
               + lam_center).reshape(K)
    elif cfg.problem_type == ProblemType.SVD:
        keys, use2 = rng.split_batch(keys)
        u = rng.normal_like_batch(use2, (m,), cfg.dtype)
        u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
        lam = jnp.ones((K,), cfg.dtype)       # σ init = 1 (AMS:141)
    rdt = cfg.real_dtype
    return Population(
        v=v, u=u, lam=lam,
        weight=jnp.ones((K,), rdt),
        alpha=jnp.full((K,), cfg.alpha_initial, rdt),
        stuck=jnp.zeros((K,), jnp.int32),
        status=jnp.full((K,), int(CandidateStatus.EXPLORING), jnp.int8),
        residual=jnp.full((K,), jnp.inf, rdt),
        prev_residual=jnp.full((K,), jnp.inf, rdt),
        psi_level=jnp.zeros((K,), jnp.int32),
        keys=keys,
        retire_count=jnp.zeros((K,), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Shared post-step bookkeeping: α adaptation + state machine (M4f/M4h/M4i)
# ---------------------------------------------------------------------------

def _adapt_and_classify(cfg: SolverConfig, pop: Population, new_residual: jax.Array,
                        solve_ok: jax.Array, strat: StrategyState,
                        params_finite: jax.Array,
                        floor_scale=1.0) -> Population:
    """Apply the α adaptation rule (AMS:306-316), failure handling (AMS:287-293) and
    convergence test (AMS:318-331) as masked updates. Frozen for CONVERGED/RETIRED."""
    frozen = (pop.status == CandidateStatus.CONVERGED) | \
             (pop.status == CandidateStatus.RETIRED)
    active = ~frozen

    prev = pop.residual
    improved = new_residual < cfg.improve_ratio * prev
    regressed = _regressed_mask(cfg, prev, new_residual, floor_scale)

    alpha = jnp.where(
        improved, jnp.minimum(pop.alpha * cfg.alpha_grow, 1.0),
        jnp.where(regressed, jnp.maximum(pop.alpha * cfg.alpha_shrink, cfg.alpha_min),
                  jnp.maximum(pop.alpha * cfg.alpha_decay, cfg.alpha_min)))
    status = jnp.where(
        improved, jnp.int8(CandidateStatus.REFINING),
        jnp.where(regressed, jnp.int8(CandidateStatus.STUCK),
                  jnp.int8(CandidateStatus.EXPLORING)))
    stuck = jnp.where(regressed, pop.stuck + 1,
                      jnp.where(improved, jnp.maximum(pop.stuck - 1, 0), pop.stuck))
    weight = pop.weight

    # solve failure: weight ×0.001, α halved, stuck++ (AMS:287-293)
    fail = active & ~solve_ok
    weight = jnp.where(fail, weight * 1e-3, weight)
    alpha = jnp.where(fail, jnp.maximum(pop.alpha * 0.5, cfg.alpha_min), alpha)
    stuck = jnp.where(fail, pop.stuck + 1, stuck)
    status = jnp.where(fail, jnp.int8(CandidateStatus.STUCK), status)

    # retirement at stuck ≥ cap (AMS:19, 290-291)
    retire = active & (stuck >= cfg.max_stuck_for_retirement)
    status = jnp.where(retire, jnp.int8(CandidateStatus.RETIRED), status)

    # convergence: residual under current threshold AND all params finite
    # (AMS:318-331). The threshold is floored at the compute dtype's reachable
    # precision (cfg.convergence_floor); refinement closes the rest
    # (ops/refine.py). ``floor_scale`` maps the relative floor onto the
    # problem's residual units: 1 for linear (already relative), ‖A‖-scale for
    # eig/SVD (absolute residuals, AMS:297/301) — without it nothing converges
    # on c64 hardware once ‖A‖ ≫ 1.
    # BOTH threshold terms scale with the problem's residual units
    # (floor_scale = 1 for linear — already relative; ‖A‖-scale for eig/SVD
    # absolute residuals): an absolute threshold spuriously converges random
    # vectors on small-norm operands (resid ≤ 2‖A‖ for ANY unit vector) and
    # is unreachable on large-norm ones (code-review r3; the reference's
    # absolute thresholds are the same bug class as its absolute Ψ base)
    if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        thresh_eff = jnp.maximum(strat.threshold,
                                 cfg.convergence_floor) * floor_scale
    else:
        # eig/SVD: accept only at the dtype floor, never at the strategy's
        # loosened dynamic threshold. A loosely-accepted eigen/SVD candidate
        # FREEZES with an O(threshold) vector error, counts as "distinct" on
        # the device, and is later snapped by the finisher onto whatever true
        # eigenpair/triplet is nearest — several crude slots collapse onto one
        # (measured at 8192²: device count hit 16 at iteration 7 under a
        # ~1e-2-loose threshold; the honest post-finisher count was 5). The
        # reference accepts at the dynamic threshold (AMS:318-331) and its
        # 2/8-forever scenarios are this same failure. Linear keeps the
        # dynamic acceptance: its candidates track ONE solution and the
        # refinement stage closes the gap deterministically. The bar is the
        # user's tol or the dtype floor, whichever is reachable
        # (convergence_floor is 0.0 on full-precision backends).
        thresh_eff = jnp.maximum(cfg.tol, cfg.convergence_floor) * floor_scale
    conv = active & (new_residual < thresh_eff) & params_finite & solve_ok
    status = jnp.where(conv, jnp.int8(CandidateStatus.CONVERGED), status)
    weight = jnp.where(conv, jnp.ones_like(weight), weight)
    stuck = jnp.where(conv, 0, stuck)

    return Population(
        v=pop.v, u=pop.u, lam=pop.lam,
        weight=jnp.where(frozen, pop.weight, weight),
        alpha=jnp.where(frozen, pop.alpha, alpha),
        stuck=jnp.where(frozen, pop.stuck, stuck),
        status=jnp.where(frozen, pop.status, status),
        residual=jnp.where(frozen, pop.residual, new_residual),
        prev_residual=jnp.where(frozen, pop.prev_residual, prev),
        psi_level=pop.psi_level, keys=pop.keys, retire_count=pop.retire_count)


def _finite_rows(x: jax.Array) -> jax.Array:
    if jnp.iscomplexobj(x):
        return jnp.all(jnp.isfinite(x.real) & jnp.isfinite(x.imag), axis=-1)
    return jnp.all(jnp.isfinite(x), axis=-1)


# ---------------------------------------------------------------------------
# Linear systems (M4e, AMS:273-286)
# ---------------------------------------------------------------------------

def step_linear(cfg: SolverConfig, A: jax.Array, b: jax.Array, fac: LUFactors,
                pop: Population, strat: StrategyState,
                direct_solve=None) -> tuple[Population, StepStats]:
    """One population step for Ax=b.

    Device-native restructure: every candidate solves the *same* regularized system, so
    the proposal x̂ is computed once (reusing the carried factorization — the
    reference refactorizes per candidate per iteration, AMS:224-225/59) and only the
    damped per-candidate mixing ``x_k ← (1−α_k)x_k + α_k x̂`` (AMS:284-285) plus the
    residual/α/state bookkeeping is per-candidate work.

    ``direct_solve``: optional ``(fac, b) → x̂`` override for the direct branch —
    the distributed evolve passes the column-sharded
    :func:`maus_tpu.parallel.dist_qr.dist_qr_solve` here so the population
    meta-heuristic runs unchanged over a mesh-sharded factorization.
    """
    bnorm = jnp.maximum(jnp.linalg.norm(b), jnp.finfo(cfg.real_dtype).tiny)

    def direct(_):
        if direct_solve is not None:
            return direct_solve(fac, b)
        if isinstance(fac, CholFactors):
            return solve_chol(fac, b)
        if isinstance(fac, QRFactors):
            return solve_qr(fac, b)
        from ..ops.blocked_lu import BlockedLU, RBTLU, solve_lu, solve_rbt_lu
        if isinstance(fac, BlockedLU):
            return solve_lu(fac, b)
        if isinstance(fac, RBTLU):
            return solve_rbt_lu(fac, b)
        return solve_factored(fac, b)

    def iterative(_):
        # Parity with the direct branch (VERDICT r1 #7): GMRES solves the SAME
        # Ψ-regularized system (A + ΨD) x̂ = b the factorization would, not the
        # raw operator — on a singular/critical A the raw solve has no solution
        # to converge to, while the Ψ-shifted one is the reference's contract
        # (InverseIterateSolver always solves the regularized system, AMS:52).
        from ..ops.regularize import psi_magnitude, shift_diagonal
        N = A.shape[0]
        anorm = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(N)))).real \
            .astype(jnp.float32)
        psi = psi_magnitude(cfg.psi_base * anorm, strat.psi_aggression,
                            strat.frustration, 0.0)
        d = shift_diagonal(N, psi, cfg.dtype)
        diag = jnp.diagonal(A) + d
        res = gmres_batched(lambda X: X @ A.T + d[None, :] * X, b[None, :],
                            precond_diag=jacobi_from_diag(diag)[None, :],
                            tol=cfg.tol, restart=min(32, A.shape[0]),
                            max_restarts=8)
        return res.x[0]

    x_hat = jax.lax.cond(strat.solver_pref == SolverPreference.DIRECT,
                         direct, iterative, operand=None)
    ok = jnp.all(jnp.isfinite(x_hat.real) & jnp.isfinite(x_hat.imag)) \
        if jnp.iscomplexobj(x_hat) else jnp.all(jnp.isfinite(x_hat))
    solve_ok = jnp.broadcast_to(ok, (pop.capacity,))

    alpha_c = pop.alpha.astype(cfg.dtype)[:, None]
    v_new = (1.0 - alpha_c) * pop.v + alpha_c * x_hat[None, :]
    v_new = jnp.where(solve_ok[:, None], v_new, pop.v)

    resid = jnp.linalg.norm(v_new @ A.T - b[None, :], axis=-1) / bnorm
    frozen = (pop.status == CandidateStatus.CONVERGED) | \
             (pop.status == CandidateStatus.RETIRED)
    # Ψ-ladder telemetry (reference num_psi_attempts, AMS:39-104): the linear
    # path escalates at POPULATION level — every candidate solves against the
    # same shared factorization, whose rung is the strategy's ``frustration``
    # (evolve._effective_psi). Per-candidate escalation is degenerate here, so
    # the population rung IS each candidate's ladder depth.
    rung = jnp.round(strat.frustration).astype(jnp.int32)
    pop = dataclasses.replace(pop, v=jnp.where(frozen[:, None], pop.v, v_new),
                              psi_level=jnp.where(
                                  frozen, pop.psi_level,
                                  jnp.broadcast_to(rung, (pop.capacity,))))
    regress = _regress_frac(cfg, pop, resid.astype(cfg.real_dtype), frozen)
    pop = _adapt_and_classify(cfg, pop, resid.astype(cfg.real_dtype), solve_ok, strat,
                              _finite_rows(v_new))
    active_f = (~frozen).astype(jnp.float32)
    nact = jnp.maximum(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).astype(jnp.float32) * active_f).sum() / nact,
        psi_attempts_mean=strat.frustration.astype(jnp.float32),
        regress_frac=regress)


# ---------------------------------------------------------------------------
# Eigenproblems (M4d, AMS:258-283) — shifted inverse iteration, batched
# ---------------------------------------------------------------------------

def step_eigen(cfg: SolverConfig, A: jax.Array, pop: Population,
               strat: StrategyState, hess_cache=None, dist_solve=None
               ) -> tuple[Population, StepStats]:
    """One population step for Ax = λx: Rayleigh-quotient shift per candidate, then
    a *batched* regularized shifted solve ``(A − λ_k I + Ψ_k D) w_k = v_k``.

    With ``hess_cache`` (the shared Hessenberg form A = Q H Qᴴ, built once per
    evolve) the direct branch solves each shift in O(N²) via a batched Givens
    QR on (H − λ_k I) instead of a per-candidate O(N³) LU — see
    :mod:`maus_tpu.ops.hessenberg`. Without it, the vmapped-LU fallback runs.

    ``dist_solve``: optional ``(lams, B, psi) → W`` override for the direct
    branch — the distributed evolve passes the column-sharded
    :func:`maus_tpu.parallel.dist_hessenberg.dist_solve_shifted` here so the
    FULL population meta-heuristic (Ψ ladder, α adaptation, retire/respawn,
    strategy regimes) runs unchanged over a mesh-sharded operand; A's own
    appearances in this function (Rayleigh quotients, residuals, the JD
    iterative branch) are plain matmuls that GSPMD shards automatically.

    The Ψ rung here is intentionally larger than the linear path's: the Rayleigh
    shift drives (A − λI) toward exact singularity by design, and the Ψ jitter is
    what keeps the inverse-iteration solve bounded (the classic trick)."""
    N = A.shape[0]
    anorm = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(N)))).real \
        .astype(jnp.float32)
    psi_scaled = cfg.psi_base * anorm * 1e6   # ≈ eps²·‖A‖ scale for c64

    Av = pop.v @ A.T                                             # (K, N)
    vv = jnp.sum(jnp.conj(pop.v) * pop.v, axis=-1)
    rq = jnp.where(jnp.abs(vv) > 1e-12,
                   jnp.sum(jnp.conj(pop.v) * Av, axis=-1) / vv, pop.lam)
    # Shift locking: the Rayleigh quotient of a still-random iterate is
    # ≈ tr(A)/N ± ‖A‖_F/N for EVERY candidate — adopting it immediately
    # collapses the population's moment-matched shift spread onto the spectral
    # centroid and the engine only ever finds center-of-spectrum eigenpairs
    # (measured: 5-7 of 16 distinct at N=4096-8192, all |λ| ≲ 0.1 on a
    # radius-1 operand). Classic schedule instead: keep the candidate's
    # CARRIED shift (diverse by construction — init_population moment-matches,
    # population.manage pushes respawns away from claimed λ's) while the
    # iterate is unaligned, and switch to RQ — cubically-convergent RQI —
    # once the eigenresidual shows the vector has locked onto the shift's
    # nearest eigenpair. The reference re-derives the RQ every step
    # (AMS:264-268) and exhibits exactly this collapse (SURVEY §0.1).
    aligned = pop.residual < _SHIFT_LOCK_FRAC * anorm
    lam = jnp.where(aligned, rq, pop.lam)

    def direct(_):
        if hess_cache is not None or dist_solve is not None:
            from ..ops.batched_solve import psi_ladder
            from ..ops.regularize import psi_magnitude

            if dist_solve is None:
                from ..ops.hessenberg import solve_shifted_via_hessenberg
                shifted = lambda l_, b_, p_: solve_shifted_via_hessenberg(
                    hess_cache, l_, b_, p_)
            else:
                shifted = dist_solve

            def solve_at(attempt_k):
                psi = psi_magnitude(psi_scaled, strat.psi_aggression,
                                    attempt_k, pop.stuck)
                return shifted(lam, pop.v, psi)

            return psi_ladder(solve_at, pop.capacity,
                              max_attempts=cfg.max_psi_attempts)
        W, attempts = batched_shifted_solve(
            A, lam, pop.stuck, psi_scaled, strat.psi_aggression, pop.v,
            max_attempts=cfg.max_psi_attempts)
        return W, attempts

    def iterative(_):
        # Jacobi–Davidson correction equation (VERDICT r1 #7): inverse
        # iteration through the nearly singular (A − λI) is exactly where
        # restarted GMRES stalls — the eigenvalue being sought IS the
        # operator's near-null direction. Solving the PROJECTED system
        #   (I − v vᴴ)(A − λI)(I − v vᴴ) t = −r,  t ⊥ v,  r = Av − λv
        # is well-conditioned on v's complement and gives the RQI update
        # direction (v_new ∝ v + t) without inverting a singular operator.
        # Loose inner tolerance suffices (inexact JD still converges
        # superlinearly in the outer loop).
        vk = pop.v
        r = Av - lam[:, None] * vk          # λ is the RQ of v ⇒ r ⊥ v already

        def cproj(X):
            c = jnp.sum(jnp.conj(vk) * X, axis=-1, keepdims=True)
            return X - c * vk

        def matvec(X):
            Xp = cproj(X)
            return cproj(Xp @ A.T - lam[:, None] * Xp)

        diag = jnp.diagonal(A)[None, :] - lam[:, None]
        res = gmres_batched(matvec, -cproj(r), x0=jnp.zeros_like(vk),
                            precond_diag=jacobi_from_diag(diag),
                            tol=1e-2, restart=min(32, N), max_restarts=2)
        t = cproj(res.x)
        return vk + t, jnp.zeros((pop.capacity,), jnp.int32)

    W, attempts = jax.lax.cond(strat.solver_pref == SolverPreference.DIRECT,
                               direct, iterative, operand=None)
    solve_ok = _finite_rows(W) & (jnp.linalg.norm(W, axis=-1) > 0)
    # record the Ψ-ladder rung each candidate needed (reference
    # num_psi_attempts) — FROZEN slots keep their convergence-time rung
    # (parity with the linear path's telemetry contract)
    frozen_tel = (pop.status == CandidateStatus.CONVERGED) | \
        (pop.status == CandidateStatus.RETIRED)
    pop = dataclasses.replace(
        pop, psi_level=jnp.where(frozen_tel, pop.psi_level,
                                 attempts.astype(jnp.int32)))

    # damped update + renormalize (AMS:280-283). The solve returns w ∝ (A−λI)⁻¹v —
    # normalize before mixing so α mixes directions, not magnitudes.
    Wn = W / jnp.maximum(jnp.linalg.norm(W, axis=-1, keepdims=True),
                         jnp.finfo(cfg.real_dtype).tiny)
    # align phase with current v so the damped mix doesn't cancel
    phase = jnp.sum(jnp.conj(Wn) * pop.v, axis=-1)
    phase = jnp.where(jnp.abs(phase) > 1e-12, phase / jnp.abs(phase),
                      jnp.ones_like(phase))
    Wn = Wn * phase[:, None]
    # while the shift is locked (unaligned), take the FULL inverse-iteration
    # step — damping a fixed-shift power step just slows the linear
    # convergence down (the reference's α₀=0.01 relaxation is why its eig
    # scenarios stall, SURVEY §0.1); α-damped mixing resumes with RQI
    alpha_eff = jnp.where(aligned, pop.alpha.astype(cfg.real_dtype),
                          jnp.ones((), cfg.real_dtype))
    alpha_c = alpha_eff.astype(cfg.dtype)[:, None]
    v_new = (1.0 - alpha_c) * pop.v + alpha_c * Wn
    v_new = v_new / jnp.maximum(jnp.linalg.norm(v_new, axis=-1, keepdims=True),
                                jnp.finfo(cfg.real_dtype).tiny)
    v_new = jnp.where(solve_ok[:, None], v_new, pop.v)

    # refresh Rayleigh quotient and residual vs ORIGINAL matrix (M4g, AMS:297)
    Av_new = v_new @ A.T
    lam_new = jnp.sum(jnp.conj(v_new) * Av_new, axis=-1)
    resid = jnp.linalg.norm(Av_new - lam_new[:, None] * v_new, axis=-1)

    # carried λ: the locked shift persists until the NEW iterate is aligned
    # (residual and convergence still use the honest RQ above)
    aligned_new = resid < _SHIFT_LOCK_FRAC * anorm
    lam_keep = jnp.where(aligned_new, lam_new, pop.lam)

    frozen = (pop.status == CandidateStatus.CONVERGED) | \
             (pop.status == CandidateStatus.RETIRED)
    pop = dataclasses.replace(pop,
                              v=jnp.where(frozen[:, None], pop.v, v_new),
                              lam=jnp.where(frozen, pop.lam, lam_keep))
    # acceptance/regress scale: max(fro-scale, max |RQ|) — the Rayleigh
    # quotients of normalized iterates lower-bound ‖A‖₂, recovering the true
    # residual units on low-rank spectra where ‖A‖_F/√N understates them
    # (see step_svd's scale_eff comment for the measured failure)
    lam_abs = jnp.abs(pop.lam).real
    scale_eff = jnp.maximum(
        anorm.astype(cfg.real_dtype),
        jnp.max(jnp.where(jnp.isfinite(lam_abs), lam_abs, 0.0))
        .astype(cfg.real_dtype))
    regress = _regress_frac(cfg, pop, resid.astype(cfg.real_dtype), frozen,
                            floor_scale=scale_eff)
    pop = _adapt_and_classify(cfg, pop, resid.astype(cfg.real_dtype), solve_ok, strat,
                              _finite_rows(v_new) & _finite_rows(lam_new[:, None]),
                              floor_scale=scale_eff)
    active_f = (~frozen).astype(jnp.float32)
    nact = jnp.maximum(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).astype(jnp.float32) * active_f).sum() / nact,
        psi_attempts_mean=(attempts.astype(jnp.float32) * active_f).sum() / nact,
        regress_frac=regress)


# ---------------------------------------------------------------------------
# SVD (M4c, AMS:227-255) — alternating power iteration with deflation
# ---------------------------------------------------------------------------

def step_svd(cfg: SolverConfig, A: jax.Array, pop: Population,
             strat: StrategyState) -> tuple[Population, StepStats]:
    """One SVD population step.

    ``cfg.orthogonalize`` (default) runs the population as a **block**: one round
    of subspace iteration with a Rayleigh–Ritz rotation — two tall QRs and one
    K×K SVD per step, all GEMM-shaped. Per-candidate power iteration (the
    reference's literal update, AMS:233-242) converges at (σ_{i+1}/σ_i)² per
    step and stalls for thousands of iterations on clustered spectra (measured
    on a 2048×512 sparse operand with σ₁/σ₂ ≈ 0.996); the block converges at
    (σ_{K+1}/σ_i) and every candidate lands on a *distinct* Ritz triplet by
    construction. With ``orthogonalize=False`` the reference's independent
    per-candidate dynamics are preserved verbatim.
    """
    conv = pop.status == CandidateStatus.CONVERGED

    if cfg.orthogonalize:
        K, N = pop.v.shape
        M = pop.u.shape[1]
        r = min(K, M, N)
        # reseed non-finite / collapsed directions before orthogonalization
        keys, use = rng.split_batch(pop.keys)
        fresh = rng.normal_like_batch(use, (N,), cfg.dtype)
        bad = ~_finite_rows(pop.v) | (jnp.linalg.norm(pop.v, axis=-1) < 1e-12)
        V = jnp.where(bad[:, None], fresh, pop.v)
        pop = dataclasses.replace(pop, keys=keys)
        reseeded = bad

        # one block round: span{A·V} → Qu; project; QR; small SVD → Ritz triplets
        Y = (V @ A.T).T                                          # (M, K)
        Qu, _ = jnp.linalg.qr(Y)                                 # (M, r)
        Z = jnp.conj(Qu).T @ A                                   # (r, N) = QuᴴA
        Qv, Rz = jnp.linalg.qr(jnp.conj(Z).T)                    # (N, r), (r, r)
        Us, S, Vsh = jnp.linalg.svd(jnp.conj(Rz).T)              # (r,r),(r,),(r,r)
        U_ritz = Qu @ Us                                         # (M, r)
        V_ritz = Qv @ jnp.conj(Vsh).T                            # (N, r)

        # assignment: ACTIVE slots take their slot-rank Ritz triplet (full
        # coverage of the block — the diversity mechanism), CONVERGED slots
        # take the Ritz triplet they OVERLAP most with — a slot-rank
        # assignment teleports a converged candidate whenever two clustered
        # Ritz values swap order between iterations (code-review r3)
        slot_idx = jnp.arange(K) % r     # K > r: extra slots duplicate
        ovl = jnp.abs(jnp.conj(V) @ V_ritz)                      # (K, r)
        idx = jnp.where(conv, jnp.argmax(ovl, axis=-1), slot_idx)
        v_ritz = V_ritz.T[idx]                                   # (K, N)
        u_ritz = U_ritz.T[idx]

        # per-candidate MAUS dynamics (M4h parity, VERDICT r1 weak-7): each
        # candidate takes a DAMPED step toward its Ritz triplet, v ← (1−α)v +
        # α·v_ritz (AMS:280-285 semantics), with α adapted per candidate by
        # _adapt_and_classify below. Improving candidates drive α → 1, which
        # recovers the pure block update exactly; regressing/stuck candidates
        # damp their step instead of being teleported.
        def _align(new, old):
            ph = jnp.sum(jnp.conj(new) * old, axis=-1)
            ph = jnp.where(jnp.abs(ph) > 1e-12, ph / jnp.abs(ph),
                           jnp.ones_like(ph))
            return new * ph[:, None]

        tiny = jnp.finfo(cfg.real_dtype).tiny
        alpha_c = pop.alpha.astype(cfg.dtype)[:, None]
        v_mix = (1.0 - alpha_c) * V + alpha_c * _align(v_ritz, V)
        v_new = v_mix / jnp.maximum(
            jnp.linalg.norm(v_mix, axis=-1, keepdims=True), tiny)
        u_mix = (1.0 - alpha_c) * pop.u + alpha_c * _align(u_ritz, pop.u)
        u_new = u_mix / jnp.maximum(
            jnp.linalg.norm(u_mix, axis=-1, keepdims=True), tiny)
        # σ of the mixed triplet: phase-absorbed Rayleigh quotient uᴴAv
        # (equals the Ritz value S when α = 1); XLA CSEs this GEMM with the
        # residual computation's identical v_new @ A.T below
        Avm = v_new @ A.T                                        # (K, M)
        rq = jnp.sum(jnp.conj(u_new) * Avm, axis=-1)
        rq_ph = jnp.where(jnp.abs(rq) > 1e-30, rq / jnp.abs(rq),
                          jnp.ones_like(rq))
        u_new = u_new * rq_ph[:, None]    # make uᴴAv real ≥ 0 ⇒ σ = |rq|
        sigma = jnp.abs(rq).astype(cfg.real_dtype)
        s_u = jnp.linalg.norm(Avm, axis=-1).astype(cfg.real_dtype)
        solve_ok = _finite_rows(u_new) & _finite_rows(v_new)
    else:
        # reference-parity per-candidate alternating power iteration
        v = pop.v
        # Aᴴu as a GEMM: (Aᴴu)[n] = Σ_m conj(A[m,n]) u[m]  ⇒  U @ conj(A)
        Av = v @ A.T                                             # (K, M)
        s_u = jnp.linalg.norm(Av, axis=-1)
        u_new = Av / jnp.maximum(s_u[:, None], jnp.finfo(cfg.real_dtype).tiny)
        AHu = u_new @ jnp.conj(A)                                # (K, N)
        s_v = jnp.linalg.norm(AHu, axis=-1)
        v_new = AHu / jnp.maximum(s_v[:, None], jnp.finfo(cfg.real_dtype).tiny)
        sigma = jnp.maximum(s_u, s_v).astype(cfg.real_dtype)
        solve_ok = _finite_rows(u_new) & _finite_rows(v_new) & (s_u > 1e-30)
        reseeded = jnp.zeros_like(solve_ok)

    # zero-singular-value detection (AMS:243-247): a candidate whose direction
    # is annihilated by A has found a null vector — that IS a singular triplet
    # (σ=0); declare it converged instead of respinning forever. The test is
    # RELATIVE to the operand's scale (σ < 1e-8·‖A‖_F/√min(M,N)): the
    # reference's absolute 1e-8 cut misfires for small-scaled operands, the
    # same absolute-threshold failure mode as its Ψ base (core/types.py).
    a_scale = (jnp.linalg.norm(A) /
               jnp.sqrt(jnp.asarray(float(min(A.shape))))).real \
        .astype(cfg.real_dtype)
    zero_sv = s_u < 1e-8 * jnp.maximum(a_scale, jnp.finfo(cfg.real_dtype).tiny)
    sigma = jnp.where(zero_sv, 0.0, sigma)

    # two-sided residual (M4g, AMS:301)
    sig_c = sigma[:, None].astype(cfg.dtype)
    r1 = jnp.linalg.norm(v_new @ A.T - sig_c * u_new, axis=-1)
    r2 = jnp.linalg.norm(u_new @ jnp.conj(A) - sig_c * v_new, axis=-1)
    resid = (r1 + r2).astype(cfg.real_dtype)
    # for a null vector the residual IS ‖Av‖ + ‖Aᴴu‖ ≈ 0 on the v side; use v
    # only (u is arbitrary for σ=0)
    resid = jnp.where(zero_sv, r1.astype(cfg.real_dtype), resid)
    solve_ok = solve_ok | (zero_sv & _finite_rows(v_new))

    # Converged candidates are polished, not frozen: their triplet data keeps
    # updating toward machine precision (status stays CONVERGED via the state
    # machine's frozen mask) so deflation against them has no accuracy floor.
    retired = pop.status == CandidateStatus.RETIRED
    frozen = conv | retired
    # converged NULL triplets (sigma = 0 exactly) have no Ritz counterpart —
    # null directions are orthogonal to the row space the block spans, so the
    # polish mix would teleport them onto a sigma>0 triplet while status
    # stays CONVERGED (code-review r3). Freeze their data outright.
    null_conv = conv & (jnp.abs(pop.lam) == 0.0)
    keep = retired | ~solve_ok | null_conv
    # SVD failure telemetry (the reference's num_psi_attempts analogue for a
    # path with no solve ladder, AMS:249-255): a candidate "attempt" here is a
    # failed/collapsed step (reseed or non-finite update) — psi_level counts
    # them cumulatively per candidate, psi_attempts_mean reports this step's
    # failure fraction, so the strategy layer sees per-class failure pressure.
    failed_step = (~frozen) & (reseeded | ~solve_ok)
    pop = dataclasses.replace(pop,
                      v=jnp.where(keep[:, None], pop.v, v_new),
                      u=jnp.where(keep[:, None], pop.u, u_new),
                      lam=jnp.where(keep, pop.lam, sigma.astype(cfg.dtype)),
                      psi_level=pop.psi_level + failed_step.astype(jnp.int32))
    # Acceptance/regress scale: ‖A‖_F/√min(M,N) UNDERSTATES the residual
    # units on low-rank spectra (a rank-16 4096×2048 operand with σ₁=1 has
    # fro-scale 0.038, putting the c64 acceptance bar ~26× below the σ₁-set
    # residual floor — measured: the σ∈[0.33, 0.8] triplets sat at 3.7-5.8e-7
    # for 90 iterations, under tol but over the bar, and the report missed
    # them). Every candidate's σ = |uᴴAv| with ‖u‖=‖v‖=1 is a PROVABLE lower
    # bound on ‖A‖₂, so max(fro-scale, max σ) tightens toward the true
    # spectral scale from below and can never loosen acceptance beyond it.
    lam_abs = jnp.abs(pop.lam).real
    scale_eff = jnp.maximum(
        a_scale, jnp.max(jnp.where(jnp.isfinite(lam_abs), lam_abs, 0.0))
        .astype(cfg.real_dtype))
    regress = _regress_frac(cfg, pop, resid, frozen, floor_scale=scale_eff)
    # refresh the residual of polished converged candidates in place
    pop = dataclasses.replace(
        pop, residual=jnp.where(conv & solve_ok & ~null_conv, resid,
                                pop.residual))
    pop = _adapt_and_classify(cfg, pop, resid, solve_ok, strat,
                              _finite_rows(v_new) & _finite_rows(u_new),
                              floor_scale=scale_eff)
    active_f = (~frozen).astype(jnp.float32)
    nact = jnp.maximum(active_f.sum(), 1.0)
    return pop, StepStats(
        solve_fail_frac=((~solve_ok).astype(jnp.float32) * active_f).sum() / nact,
        psi_attempts_mean=(failed_step.astype(jnp.float32) * active_f).sum()
        / nact,
        regress_frac=regress)
