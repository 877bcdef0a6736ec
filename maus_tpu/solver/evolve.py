"""The jitted evolution loop — reference ``MAUS_Solver.evolve`` (AMS:551-608)
rebuilt as ``lax.while_loop`` / ``lax.scan`` over a pure iteration function.

Per-iteration order matches the reference (AMS:572-577):
diagnostics → strategy adjustment → candidate step → population management.

Two drivers share the same iteration body:

* :func:`evolve_while` — early-exits the moment the target number of distinct
  converged solutions exists (the reference's intent at AMS:583-584, minus its
  NameError); this is the production/bench path.
* :func:`evolve_scan` — fixed iteration count, returns the full per-iteration
  metrics trace (landscape energy, residual quantiles, distinct count) as stacked
  arrays: the device-side ring buffer called for in SURVEY.md §5.1.

Linear systems additionally carry the shared LU factorization across iterations and
only re-factorize when the strategy's Ψ level actually changes — the reference
refactorizes K times per iteration (AMS:224-225, AMS:59).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.types import (CandidateStatus, Population, ProblemKnowledge,
                          ProblemType, SolverConfig, StrategyState,
                          initial_strategy)
from ..ops.batched_solve import (LUFactors, shared_factor_hpd, shared_factor_qr,
                                 solve_chol)
from ..ops.refine import _combine_fac
from ..ops.regularize import psi_magnitude
from . import candidate as cand
from . import hermitian as herm
from . import population as popmgmt
from . import strategy as strat_mod


class EvolveCarry(NamedTuple):
    pop: Population
    strat: StrategyState
    fac: Optional[LUFactors]        # linear path only
    psi_cached: jax.Array           # Ψ the carried factorization was built with
    iteration: jax.Array
    best_residual: jax.Array        # best (min) residual seen so far, f32
    stall_count: jax.Array          # iterations since best_residual improved
    refactor_psi: jax.Array         # cfg.host_refactor mode only: non-zero ⇔
                                    # the loop exited asking the HOST to
                                    # rebuild the shared factorization at this
                                    # Ψ (backend.branch_memory_cap); 0.0
                                    # otherwise


class Metrics(NamedTuple):
    """Per-iteration population statistics (SURVEY.md §5.5 — same metric names as
    the reference where they exist). The three ``candidate_*`` fields carry the
    reference's per-candidate trajectories (AMS:126/142-143) when
    ``cfg.capture_history`` is on; otherwise they are zero-size placeholders."""

    landscape_energy: jax.Array
    avg_residual: jax.Array
    avg_stuckness: jax.Array
    num_distinct: jax.Array
    min_residual: jax.Array
    psi_aggression: jax.Array
    threshold: jax.Array
    solve_fail_frac: jax.Array
    candidate_residuals: jax.Array   # (K,) or (0,)
    candidate_alpha: jax.Array       # (K,) or (0,)
    candidate_status: jax.Array      # (K,) or (0,)
    candidate_params: jax.Array      # (K, N) iterates (cfg.capture_param_history,
                                     # the reference's param_history) or (0, 0)


def _effective_psi(cfg: SolverConfig, strat: StrategyState,
                   anorm) -> jax.Array:
    """Iteration-level Ψ for the shared linear factorization: base × matrix scale ×
    aggression × 10^frustration. ``frustration`` plays the role of the reference's
    per-candidate retry ``attempt`` (AMS:44) at the population level: it ratchets up
    when solves keep failing, giving the same escalation ladder without
    refactorizing mid-step.

    The result is quantized to half-decade rungs — the ladder's own granularity
    (10^(attempt/2), AMS:44). Without quantization the regime controller's gentle
    ×1.05/×0.9 aggression nudges change Ψ every iteration, and each change would
    trigger a full O(N³) refactorization of the carried LU (measured: ~10× bench
    slowdown)."""
    raw = psi_magnitude(cfg.psi_base * anorm, strat.psi_aggression,
                        strat.frustration, 0.0)
    half_decades = jnp.round(jnp.log10(jnp.maximum(raw, 1e-300)) * 2.0)
    return jnp.power(10.0, half_decades / 2.0).astype(raw.dtype)


def make_iteration(cfg: SolverConfig, knowledge: ProblemKnowledge, A: jax.Array,
                   b: Optional[jax.Array], eigh_cache: Optional[herm.EighCache],
                   target_solutions: int, hess_cache=None, mesh=None,
                   dist_block: int = 128):
    """Build the single-iteration pure function ``carry → (carry, Metrics)``.

    ``hess_cache``: shared Hessenberg form of A (non-Hermitian eig path) —
    built once per evolve by the drivers below, like ``eigh_cache``.

    ``mesh``: optional ``jax.sharding.Mesh`` with a model axis — the linear
    path's shared factorization then runs as the COLUMN-SHARDED distributed QR
    (parallel/dist_qr.py) and candidate solves go through
    ``dist_qr_solve``, so the full population meta-heuristic (Ψ ladder,
    α adaptation, retire/respawn, strategy regimes) operates on an operand
    larger than one device's factorization memory (STATUS round-2 gap 4)."""

    n = knowledge.shape[-1]
    anorm = jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(n)))
    anorm = anorm.real.astype(jnp.float32)
    if A.shape[0] == A.shape[1]:
        lam_center = (jnp.trace(A) / n).astype(A.dtype)
        lam_spread = jnp.sqrt(jnp.maximum(
            (jnp.linalg.norm(A).real ** 2) / n - jnp.abs(lam_center) ** 2,
            1e-12)).astype(jnp.float32)
    else:
        lam_center = jnp.zeros((), A.dtype)
        lam_spread = anorm

    def iteration(carry: EvolveCarry) -> tuple[EvolveCarry, Metrics]:
        # A reduced-precision default (TF32 for f32/c64 products on the GPU)
        # is fatal for residual measurement. All solver math runs at full
        # f32 precision.
        with jax.default_matmul_precision("highest"):
            return _iteration_impl(carry)

    def _iteration_impl(carry: EvolveCarry) -> tuple[EvolveCarry, Metrics]:
        pop, strat = carry.pop, carry.strat

        diag = strat_mod.compute_diagnostics(cfg, pop, strat, target_solutions)
        strat = strat_mod.adjust_strategy(cfg, strat, diag)

        fac, psi_cached = carry.fac, carry.psi_cached
        host_need = None   # host-refactor mode: set to the need flag below
        if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            psi_eff = _effective_psi(cfg, strat, anorm).astype(psi_cached.dtype)
            need = psi_eff != psi_cached
            hpd = knowledge.is_positive_definite

            if cfg.host_refactor and mesh is None:
                # Host-mediated refactorization (see SolverConfig.host_refactor):
                # no factorization is built inside this program. When the Ψ
                # rung moves, the WHOLE iteration's effects are discarded at
                # the bottom of this function and ``refactor_psi`` is set, so
                # the while-loop exits with the carry untouched; the host
                # rebuilds the factorization in a standalone program and
                # re-enters. On re-entry the same diagnostics/strategy
                # recompute the same psi_eff (pure functions of the carry),
                # need is then False, and the trajectory continues exactly as
                # the fused lax.cond path would have.
                host_need = need
                pop, stats = cand.step_linear(cfg, A, b, fac, pop, strat)
            else:
                if mesh is not None:
                    from ..ops.regularize import apply_shift
                    from ..parallel.dist_qr import dist_qr, dist_qr_solve

                    def refactor(_):
                        return dist_qr(mesh, apply_shift(A, psi_eff),
                                       block=dist_block)

                    def direct_solve(fac_, b_):
                        return dist_qr_solve(mesh, fac_, b_, block=dist_block)
                else:
                    def refactor(_):
                        return shared_factor_hpd(A, psi_eff) if hpd \
                            else shared_factor_qr(A, psi_eff)

                    direct_solve = None

                fac = jax.lax.cond(need, refactor, lambda _: fac, operand=None)
                psi_cached = psi_eff
                pop, stats = cand.step_linear(cfg, A, b, fac, pop, strat,
                                              direct_solve=direct_solve)
        elif cfg.problem_type == ProblemType.EIGENVALUE and mesh is not None:
            # FULL engine over a mesh-sharded operand (VERDICT r2 #1): the
            # per-candidate shifted solves route through the column-sharded
            # Hessenberg form (hess_cache is a DistHess here, built once by
            # the drivers below); Hermitian operands take this path too — a
            # replicated full eigh would defeat the sharding, and the dist
            # Hessenberg of a Hermitian A is tridiagonal anyway.
            from ..parallel.dist_hessenberg import dist_solve_shifted

            def _dsolve(lams_, B_, psi_):
                return dist_solve_shifted(mesh, hess_cache, lams_, B_, psi_)

            pop, stats = cand.step_eigen(cfg, A, pop, strat,
                                         dist_solve=_dsolve)
        elif cfg.problem_type == ProblemType.EIGENVALUE and knowledge.is_hermitian:
            if eigh_cache is not None:
                pop, stats = herm.step_hermitian(cfg, A, eigh_cache, pop, strat)
            else:   # large-N / sparse: per-candidate deflated Lanczos
                pop, stats = herm.step_hermitian_lanczos(cfg, A, pop, strat)
        elif cfg.problem_type == ProblemType.EIGENVALUE:
            pop, stats = cand.step_eigen(cfg, A, pop, strat,
                                         hess_cache=hess_cache)
        else:
            # SVD: step_svd's block round is plain matmuls + thin QRs — a
            # mesh-sharded A distributes under GSPMD with no explicit routing
            # (A is the only O(M·N) object; everything else is O((M+N)·K))
            pop, stats = cand.step_svd(cfg, A, pop, strat)

        pop = popmgmt.manage(cfg, pop, strat, diag, target_solutions,
                             lam_scale=lam_spread, lam_center=lam_center)

        # population-level escalation pressure (see _effective_psi)
        bad_step = (stats.solve_fail_frac > 0.5) | (stats.regress_frac > 0.5)
        frustration = jnp.where(
            stats.solve_fail_frac > 0.5,
            jnp.minimum(strat.frustration + 1.0, 24.0),
            jnp.where(stats.solve_fail_frac == 0.0,
                      jnp.maximum(strat.frustration - 0.25, 0.0),
                      strat.frustration))
        # direct↔GMRES failover (reference M3e, AMS:98-102, at population level):
        # after a few consecutive bad steps of the preferred method, switch method.
        pref_failures = jnp.where(bad_step, strat.pref_failures + 1.0,
                                  jnp.maximum(strat.pref_failures - 1.0, 0.0))
        flip = pref_failures >= 3.0
        solver_pref = jnp.where(flip, 1 - strat.solver_pref, strat.solver_pref)
        pref_failures = jnp.where(flip, 0.0, pref_failures)
        strat = dataclasses.replace(strat, frustration=frustration,
                                    pref_failures=pref_failures,
                                    solver_pref=solver_pref)

        # stagnation tracking for early stop (cfg.stall_limit): progress is
        # EITHER a better best ACTIVE residual than LAST iteration's, or a new
        # distinct solution. Active-only and non-monotone on purpose: once any
        # candidate converges, the global minimum saturates at the floor and a
        # monotone tracker goes blind — respawned candidates descending from
        # residual ≈ 1 toward a missing eigenpair registered no progress and
        # stall_limit killed multi-solution searches two short of target
        # (measured 14/16 at N=1024). A respawn wave bumps the active minimum
        # UP for one non-improved tick; its descent resets the counter.
        frozen_now = (pop.status == CandidateStatus.CONVERGED) | \
            (pop.status == CandidateStatus.RETIRED)
        cur_min = jnp.min(jnp.where(
            jnp.isfinite(pop.residual) & ~frozen_now, pop.residual,
            jnp.inf)).astype(jnp.float32)
        improved = (cur_min < carry.best_residual * 0.99) | \
            (strat.num_distinct > carry.strat.num_distinct)
        # carried as PREV active-min; with no active slot this iteration
        # (everything converged/retired) keep the last finite value
        best_residual = jnp.where(jnp.isfinite(cur_min), cur_min,
                                  carry.best_residual)
        stall_count = jnp.where(improved, 0, carry.stall_count + 1)

        if cfg.capture_history:
            hist_res = pop.residual
            hist_alpha = pop.alpha
            hist_status = pop.status
        else:
            hist_res = jnp.zeros((0,), pop.residual.dtype)
            hist_alpha = jnp.zeros((0,), pop.alpha.dtype)
            hist_status = jnp.zeros((0,), pop.status.dtype)
        hist_params = pop.v if cfg.capture_param_history \
            else jnp.zeros((0, 0), pop.v.dtype)
        metrics = Metrics(
            landscape_energy=strat.landscape_energy,
            avg_residual=strat.avg_residual,
            avg_stuckness=strat.avg_stuckness,
            num_distinct=strat.num_distinct,
            min_residual=jnp.min(jnp.where(jnp.isfinite(pop.residual), pop.residual,
                                           jnp.inf)),
            psi_aggression=strat.psi_aggression,
            threshold=strat.threshold,
            solve_fail_frac=stats.solve_fail_frac,
            candidate_residuals=hist_res,
            candidate_alpha=hist_alpha,
            candidate_status=hist_status,
            candidate_params=hist_params)
        new_carry = EvolveCarry(pop=pop, strat=strat, fac=fac,
                                psi_cached=psi_cached,
                                iteration=carry.iteration + 1,
                                best_residual=best_residual,
                                stall_count=stall_count,
                                refactor_psi=jnp.zeros((), jnp.float32))
        if host_need is None:
            return new_carry, metrics
        # host-refactor mode: when the Ψ rung moved, discard this iteration
        # entirely (the step above ran against the stale factorization) and
        # hand the original carry back with the requested Ψ flagged — the
        # while-loop cond exits on refactor_psi != 0 and the host re-enters
        # after rebuilding fac. ``fac`` is identical in both branches (never
        # modified in-program in this mode), so the cond is pure data select.
        frozen_carry = carry._replace(
            refactor_psi=psi_eff.astype(jnp.float32))
        zero_metrics = jax.tree.map(jnp.zeros_like, metrics)
        return jax.lax.cond(host_need,
                            lambda: (frozen_carry, zero_metrics),
                            lambda: (new_carry, metrics))

    return iteration


@partial(jax.jit, static_argnames=("cfg", "knowledge", "mesh", "dist_block"))
def init_carry(cfg: SolverConfig, knowledge: ProblemKnowledge, A: jax.Array,
               key: jax.Array, mesh=None, dist_block: int = 128
               ) -> EvolveCarry:
    # jitted: population init is one program instead of many eager ops
    with jax.default_matmul_precision("highest"):
        return _init_carry_impl(cfg, knowledge, A, key, mesh, dist_block)


def _init_carry_impl(cfg: SolverConfig, knowledge: ProblemKnowledge, A: jax.Array,
                     key: jax.Array, mesh=None, dist_block: int = 128
                     ) -> EvolveCarry:
    n = knowledge.shape[-1]
    if A.shape[0] == A.shape[1]:
        lam_center = (jnp.trace(A) / n).astype(A.dtype)
        lam_scale = jnp.sqrt(jnp.maximum(
            (jnp.linalg.norm(A).real ** 2) / n - jnp.abs(lam_center) ** 2,
            1e-12))
    else:
        lam_center = jnp.zeros((), A.dtype)
        lam_scale = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(n)))).real
    pop = cand.init_population(cfg, key, knowledge.shape, lam_scale=lam_scale,
                               lam_center=lam_center)
    strat = initial_strategy(cfg, knowledge)
    if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        n = knowledge.shape[-1]
        anorm = (jnp.linalg.norm(A) / jnp.sqrt(jnp.asarray(float(n)))).real \
            .astype(jnp.float32)
        psi0 = _effective_psi(cfg, strat, anorm)
        if mesh is not None:
            from ..ops.regularize import apply_shift
            from ..parallel.dist_qr import dist_qr

            fac = dist_qr(mesh, apply_shift(A, psi0), block=dist_block)
        elif knowledge.is_positive_definite:
            fac = shared_factor_hpd(A, psi0)
        else:
            fac = shared_factor_qr(A, psi0)
    else:
        fac, psi0 = None, jnp.asarray(0.0, jnp.float32)
    return EvolveCarry(pop=pop, strat=strat, fac=fac,
                       psi_cached=jnp.asarray(psi0, jnp.float32),
                       iteration=jnp.asarray(0, jnp.int32),
                       best_residual=jnp.asarray(jnp.inf, jnp.float32),
                       stall_count=jnp.asarray(0, jnp.int32),
                       refactor_psi=jnp.zeros((), jnp.float32))


def _use_hessenberg(cfg: SolverConfig, knowledge: ProblemKnowledge) -> bool:
    """Shared Hessenberg reduction for the non-Hermitian eig path: one O(N³)
    setup turns every per-candidate shifted solve into O(N²) (ops/hessenberg).
    Hermitian operands take the eigh/Lanczos fast paths instead."""
    return cfg.problem_type == ProblemType.EIGENVALUE and \
        not knowledge.is_hermitian and cfg.use_hessenberg


def _use_shared_eigh(cfg: SolverConfig, knowledge: ProblemKnowledge) -> bool:
    """Shared full eigh for dense moderate-N Hermitian operands; deflated
    Lanczos otherwise (cfg.eigh_max_n; reference dense/sparse split at
    AMS:159/186)."""
    if cfg.problem_type != ProblemType.EIGENVALUE or not knowledge.is_hermitian:
        return False
    n = knowledge.shape[-1]
    return n <= cfg.eigh_max_n and not knowledge.is_sparse_input


def _stop_condition(cfg: SolverConfig, target_solutions: int, carry: EvolveCarry
                    ) -> jax.Array:
    """Done ⇔ the target number of distinct converged solutions exists (reference
    intent at AMS:583-584), or the population has fully stagnated (no best-
    residual improvement for cfg.stall_limit iterations — further O(N²)-per-
    iteration work cannot help; the refinement stage takes over from here).

    SVD compares against the TRACED target (strat.target_dynamic): the rank is
    re-estimated from the converged σ spectrum every iteration (AMS:463-470),
    so a wrong initial host estimate can't stop the run early or strand it."""
    target = carry.strat.target_dynamic \
        if cfg.problem_type == ProblemType.SVD else target_solutions
    return (carry.strat.num_distinct >= target) | \
        (carry.stall_count >= cfg.stall_limit)


def _setup_caches(cfg: SolverConfig, knowledge: ProblemKnowledge, A, mesh):
    """Per-evolve one-time O(N³) factorizations shared by every iteration.

    With a mesh, the eig path builds the COLUMN-SHARDED Hessenberg form
    (parallel/dist_hessenberg.py) for Hermitian and general operands alike —
    the replicated eigh/Lanczos fast paths would defeat the sharding."""
    if mesh is not None and cfg.problem_type == ProblemType.EIGENVALUE:
        from ..parallel.dist_hessenberg import dist_hessenberg
        return None, dist_hessenberg(mesh, A)
    eigh_cache = herm.eigh_setup(A) if _use_shared_eigh(cfg, knowledge) else None
    hess_cache = None
    if _use_hessenberg(cfg, knowledge):
        from ..ops.hessenberg import reduce_hessenberg_auto
        hess_cache = reduce_hessenberg_auto(A)
    return eigh_cache, hess_cache


@partial(jax.jit, static_argnames=("cfg", "knowledge",
                                   "target_solutions", "mesh", "dist_block"),
         donate_argnames=("carry0",))
def evolve_while(cfg: SolverConfig, knowledge: ProblemKnowledge, A: jax.Array,
                 b: Optional[jax.Array], key: jax.Array, max_iterations: int,
                 target_solutions: int,
                 carry0: Optional[EvolveCarry] = None, mesh=None,
                 dist_block: int = 128,
                 hess0=None) -> tuple[EvolveCarry, Metrics]:
    """Run until the distinct-solution target is met or ``max_iterations``.
    ``carry0`` resumes from a checkpointed state (max_iterations then bounds the
    TOTAL iteration count, consistent with the saved carry's counter).
    ``carry0`` is DONATED: its device buffers alias the loop carry (at 16384²
    the Q,R factors are 4.3 GB — without donation the program holds input,
    loop, and output copies and overflows the 16 GB chip). Callers must not
    touch a passed carry object after the call.
    ``max_iterations`` is a TRACED operand (it only feeds the while-loop
    condition), so chunked checkpointing and resumed runs with different
    bounds reuse ONE compiled program.
    ``mesh``: run the linear path's factorization column-sharded (see
    :func:`make_iteration`)."""
    if hess0 is not None:
        # caller pre-built the (possibly distributed) Hessenberg form — e.g.
        # eig(mesh=) builds it once and reuses it for the finisher;
        # api._hoisted_hessenberg passes it in PLANE form (ops/refine.FacPlanes
        # — complex jit arguments materialize twice on this backend) and the
        # combine folds at trace time
        eigh_cache, hess_cache = None, _combine_fac(hess0)
    else:
        eigh_cache, hess_cache = _setup_caches(cfg, knowledge, A, mesh)
    step = make_iteration(cfg, knowledge, A, b, eigh_cache, target_solutions,
                          hess_cache=hess_cache, mesh=mesh,
                          dist_block=dist_block)
    if carry0 is None:
        carry0 = init_carry(cfg, knowledge, A, key, mesh=mesh,
                            dist_block=dist_block)
    _, m0 = jax.eval_shape(step, carry0)
    zero_metrics = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), m0)

    def cond(state):
        carry, _ = state
        return (carry.iteration < max_iterations) & \
            ~_stop_condition(cfg, target_solutions, carry) & \
            (carry.refactor_psi == 0.0)   # host-refactor handoff (cfg.host_refactor)

    def body(state):
        carry, _ = state
        return step(carry)

    return jax.lax.while_loop(cond, body, (carry0, zero_metrics))


@partial(jax.jit, static_argnames=("cfg", "knowledge", "num_iterations",
                                   "target_solutions", "mesh", "dist_block"),
         donate_argnames=("carry0",))
def evolve_scan(cfg: SolverConfig, knowledge: ProblemKnowledge, A: jax.Array,
                b: Optional[jax.Array], key: jax.Array, num_iterations: int,
                target_solutions: int,
                carry0: Optional[EvolveCarry] = None, mesh=None,
                dist_block: int = 128,
                hess0=None,
                iteration_bound=None) -> tuple[EvolveCarry, Metrics]:
    """Fixed-length run returning stacked per-iteration metrics (frozen once the
    stop condition hits, so trailing iterations are cheap no-ops).

    ``iteration_bound``: optional TRACED total-iteration cap — iterations
    freeze once ``carry.iteration`` reaches it. The host-refactor driver
    re-enters with the SAME static ``num_iterations`` and this bound, so
    every re-entry reuses one compiled program (a static remaining-length
    would recompile per handoff — 20-120 s each on this backend)."""
    if hess0 is not None:
        # caller pre-built the (possibly distributed) Hessenberg form — e.g.
        # eig(mesh=) builds it once and reuses it for the finisher;
        # api._hoisted_hessenberg passes it in PLANE form (ops/refine.FacPlanes
        # — complex jit arguments materialize twice on this backend) and the
        # combine folds at trace time
        eigh_cache, hess_cache = None, _combine_fac(hess0)
    else:
        eigh_cache, hess_cache = _setup_caches(cfg, knowledge, A, mesh)
    step = make_iteration(cfg, knowledge, A, b, eigh_cache, target_solutions,
                          hess_cache=hess_cache, mesh=mesh,
                          dist_block=dist_block)
    if carry0 is None:
        carry0 = init_carry(cfg, knowledge, A, key, mesh=mesh,
                            dist_block=dist_block)
    _, m0 = jax.eval_shape(step, carry0)
    zero_metrics = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), m0)

    def body(carry, _):
        done = _stop_condition(cfg, target_solutions, carry) | \
            (carry.refactor_psi != 0.0)   # host-refactor handoff: freeze until
                                          # the host rebuilds the factorization
        if iteration_bound is not None:
            done = done | (carry.iteration >= iteration_bound)

        def frozen(c):
            return c, zero_metrics

        carry_new, metrics = jax.lax.cond(done, frozen, step, carry)
        return carry_new, metrics

    return jax.lax.scan(body, carry0, None, length=num_iterations)
