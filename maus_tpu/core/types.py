"""Core types for the device-native MAUS framework.

The reference (``/root/reference/Adaptive_Matrix_Solver_0.1.py``) keeps per-candidate
state in Python objects (``SolutionCandidate.__init__``, AMS:107-143) and global state
in mutable dicts (``strat_params`` AMS:359-363, ``problem_knowledge`` AMS:350-356).
Here the same state is split along the jit boundary:

* **static** configuration (:class:`SolverConfig`) — hashable frozen dataclass, part of
  the compilation cache key;
* **traced** state pytrees (:class:`Population`, :class:`StrategyState`) — struct-of-
  arrays over a fixed-capacity candidate axis so every per-candidate operation is one
  batched device op instead of a Python loop (reference loops at AMS:574-576).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np


class ProblemType(enum.IntEnum):
    """Problem classes, mirroring the reference ``ProblemType`` enum (AMS:10-13)."""

    EIGENVALUE = 0
    SOLVE_LINEAR_SYSTEM = 1
    SVD = 2


class CandidateStatus(enum.IntEnum):
    """Candidate lifecycle states (reference ``SolutionCandidate.State``, AMS:109-110).

    Stored as an int8 field of the population SoA; all transitions are masked
    ``jnp.where`` updates, never Python-level branching.
    """

    EXPLORING = 0
    REFINING = 1
    STUCK = 2
    CONVERGED = 3
    RETIRED = 4


class SolverPreference(enum.IntEnum):
    """Local-solver dispatch preference (reference strings 'direct_solve'/'iterative_gmres',
    AMS:359-422). An int code so it can live in the traced :class:`StrategyState`."""

    DIRECT = 0
    GMRES = 1


class StabilityState(enum.IntEnum):
    """Global stability classification (reference strings 'Stable'/'Fragile'/'Critical'
    in ``problem_knowledge['matrix_stability_state']``, AMS:407-416, AMS:473-475)."""

    STABLE = 0
    FRAGILE = 1
    CRITICAL = 2


# ---------------------------------------------------------------------------
# Static configuration
# ---------------------------------------------------------------------------

# effective-rank cut σ/σ_max (AMS:463-470) — module-level so host-side rank
# estimation (solver/diagnose.py, which runs BEFORE a config exists) and the
# config default cannot drift apart
RANK_REL_CUT = 1e-4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable; safe as a jit static argument).

    Default values carry over the reference's module-level ``GLOBAL_*`` constants
    (AMS:16-26) except where the survey documents the reference value as a bug
    (SURVEY.md §0.1): the step-size adaptation gains (``alpha_grow``/``alpha_shrink``,
    reference 1.1/0.95 at AMS:307-316 never converge) and candidate initialization
    (zero-mean here; reference's non-zero-mean U[0,1] init collapses diversity,
    AMS:130).
    """

    problem_type: ProblemType = ProblemType.SOLVE_LINEAR_SYSTEM
    # Fixed population capacity (the reference grows/shrinks a Python list,
    # AMS:504-549; we flip active masks over a fixed-size axis instead).
    num_candidates: int = 16
    # Global convergence tolerance (AMS:25, constructor default AMS:341).
    tol: float = 1e-8
    # --- Ψ regularization ladder (M3a, AMS:44) ---
    # Ψ is RELATIVE to the matrix scale ‖A‖_F/√N (the reference's absolute 1e-20,
    # AMS:16, silently breaks for badly scaled operands). The base rung must be far
    # below eps²·κ so regularization never becomes the residual floor; escalation
    # reaches O(eps·‖A‖) only under repeated failure.
    psi_base: float = 1e-18
    max_psi_attempts: int = 4        # batched ladder depth per step (reference 25, AMS:18)
    # --- step-size adaptation (M4h, AMS:306-316; gains re-derived, see SURVEY §0.1) ---
    alpha_initial: float = 0.7       # reference 0.01 (AMS:17) provably cannot converge
    alpha_grow: float = 1.5          # reference 1.1
    alpha_shrink: float = 0.5        # reference 0.5
    alpha_decay: float = 0.98        # reference 0.95
    alpha_min: float = 1e-6
    improve_ratio: float = 0.9       # residual < 0.9·prev → grow (AMS:307)
    regress_ratio: float = 1.5       # residual > 1.5·prev → shrink (AMS:310)
    # --- stuckness / retirement (M2/M4f) ---
    max_stuck_for_retirement: int = 8   # AMS:19
    max_stuck_for_pruning: int = 4      # AMS:26
    min_weight: float = 1e-10           # AMS:20
    # --- distinct-solution similarity thresholds (M5d, AMS:21-24) ---
    vector_similarity_tol: float = 0.999
    lambda_similarity_tol: float = 1e-5
    sigma_similarity_abs: float = 1e-6
    sigma_similarity_rel: float = 1e-4
    # σ/σ_max below this counts as outside the effective rank (AMS:463-470);
    # a DEDICATED knob — reusing sigma_similarity_rel (the duplicate-σ
    # tolerance) would couple dedup tightening to rank detection
    rank_rel_cut: float = RANK_REL_CUT
    # --- numerics ---
    dtype: Any = jnp.complex64       # device compute dtype
    convergence_floor: float = 0.0   # dtype precision floor for the convergence
                                     # test: candidates count as converged at
                                     # max(threshold, floor); the f64 refinement
                                     # pass then closes the gap to tol (c64
                                     # cannot reach 1e-8 relative residual alone)
    refine: bool = True              # mixed-precision iterative refinement of the
                                     # final/candidate solutions (f64 split residuals)
    max_refine_steps: int = 3
    # --- SVD/eig block behavior ---
    eigh_max_n: int = 2048           # Hermitian path: shared full eigh up to this
                                     # N; beyond it (or for sparse-classified
                                     # inputs) per-candidate deflated Lanczos
                                     # (the reference's eigsh branch, AMS:186-210)
    use_hessenberg: bool = True      # non-Hermitian eig: reduce A = Q H Qᴴ once
                                     # and run every shifted solve as an O(N²)
                                     # Givens QR on (H − λI) instead of a
                                     # per-candidate O(N³) LU (ops/hessenberg)
    orthogonalize: bool = True       # block-orthogonalize SVD/eig candidate vectors
                                     # (subspace iteration); fixes the reference's
                                     # diversity collapse (SURVEY §0.1) while keeping
                                     # the per-candidate machinery
    # --- which solutions count & early stop (AMS:583-584) ---
    target_num_solutions: Optional[int] = None   # default: problem-dependent
    energy_stop: float = 0.05
    stall_limit: int = 10            # stop when the population's best residual
                                     # hasn't improved for this many iterations
                                     # (the reference loops to max_iterations
                                     # even when fully stagnant)
    capture_history: bool = False    # include per-candidate residual/α/status
                                     # trajectories in the scan metrics (the
                                     # reference's residual_history,
                                     # AMS:126/142-143 — off by default: it costs
                                     # O(iters·K) output memory)
    capture_param_history: bool = False  # additionally capture the solution
                                     # ITERATES (pop.v) per iteration — the
                                     # reference's param_history (AMS:126,
                                     # 142-143). O(iters·K·N) output memory;
                                     # implies nothing about capture_history.
    host_refactor: Optional[bool] = None  # linear path: when the strategy's Ψ
                                     # rung changes, rebuild the shared
                                     # factorization in a SEPARATE host-driven
                                     # program instead of a lax.cond branch
                                     # inside the evolve loop — for a backend
                                     # whose compiler caps a branch's scratch
                                     # memory below a large QR's needs. It
                                     # trades a rare extra loop entry/exit
                                     # for compiling at any N. None = auto
                                     # (backend.needs_host_refactor: off on
                                     # every supported platform).

    def __post_init__(self):
        object.__setattr__(self, "problem_type", ProblemType(self.problem_type))
        object.__setattr__(self, "dtype", jnp.dtype(self.dtype))

    def __hash__(self):
        return hash((self.problem_type, self.num_candidates, self.tol, self.psi_base,
                     self.max_psi_attempts, self.alpha_initial, self.alpha_grow,
                     self.alpha_shrink, self.alpha_decay, self.alpha_min,
                     self.improve_ratio, self.regress_ratio,
                     self.max_stuck_for_retirement, self.max_stuck_for_pruning,
                     self.min_weight, self.vector_similarity_tol,
                     self.lambda_similarity_tol, self.sigma_similarity_abs,
                     self.sigma_similarity_rel, self.rank_rel_cut,
                     str(self.dtype),
                     self.use_hessenberg,
                     self.convergence_floor, self.refine,
                     self.max_refine_steps, self.eigh_max_n, self.orthogonalize,
                     self.target_num_solutions, self.energy_stop,
                     self.stall_limit, self.capture_history,
                     self.capture_param_history, self.host_refactor))

    @property
    def real_dtype(self):
        return jnp.finfo(self.dtype).dtype if jnp.issubdtype(self.dtype, jnp.floating) \
            else jnp.dtype(jnp.float32 if self.dtype == jnp.complex64 else jnp.float64)


# ---------------------------------------------------------------------------
# Traced pytrees
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Population:
    """Struct-of-arrays candidate population (fixed capacity K).

    Replaces the reference's list of ``SolutionCandidate`` objects (AMS:107-337).
    ``v`` is the primary iterate: x for linear systems, the eigenvector for
    eigenproblems, the *right* singular vector for SVD. ``u`` is the SVD left
    vector (``None`` for other problem types). ``lam`` holds λ (eig) or σ (SVD,
    real part) and is unused for linear systems.
    """

    v: jax.Array                 # (K, N) complex
    u: Optional[jax.Array]       # (K, M) complex or None
    lam: jax.Array               # (K,) complex
    weight: jax.Array            # (K,) real  — candidate weight w_k (AMS:120)
    alpha: jax.Array             # (K,) real  — local step size (AMS:124)
    stuck: jax.Array             # (K,) int32 — stuck counter (AMS:125)
    status: jax.Array            # (K,) int8  — CandidateStatus code
    residual: jax.Array          # (K,) real  — ‖·‖ residual vs ORIGINAL matrix (M4g)
    prev_residual: jax.Array     # (K,) real
    psi_level: jax.Array         # (K,) int32 — current rung on the Ψ ladder
    keys: jax.Array              # (K, 2) uint32 — per-candidate PRNG streams
    retire_count: jax.Array      # (K,) int32 — times this slot was re-initialized

    @property
    def capacity(self) -> int:
        return self.v.shape[0]

    @property
    def active_mask(self) -> jax.Array:
        return self.status != CandidateStatus.RETIRED

    @property
    def converged_mask(self) -> jax.Array:
        return self.status == CandidateStatus.CONVERGED


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StrategyState:
    """Global adaptive strategy, the traced half of the reference's ``strat_params``
    dict (AMS:359-363) plus the mutable parts of ``problem_knowledge`` (AMS:350-356)
    and the landscape diagnostics (AMS:424-475)."""

    psi_aggression: jax.Array        # scalar f32 (reference 'psi_aggression_factor')
    spawn_rate: jax.Array            # scalar f32 ('num_spawn_factor')
    threshold: jax.Array             # scalar f32 ('current_convergence_threshold')
    solver_pref: jax.Array           # scalar i32 (SolverPreference code)
    stability: jax.Array             # scalar i32 (StabilityState code)
    landscape_energy: jax.Array      # scalar f32 (AMS:459-472)
    avg_residual: jax.Array          # scalar f32
    avg_stuckness: jax.Array         # scalar f32
    num_distinct: jax.Array          # scalar i32 — distinct converged solutions (M5d)
    frustration: jax.Array           # scalar f32 — population-level Ψ escalation rung
    pref_failures: jax.Array         # scalar f32 — consecutive bad steps of the
                                     # preferred method; drives direct↔GMRES
                                     # failover (reference M3e, AMS:98-102)
    target_dynamic: jax.Array        # scalar i32 — SVD effective-rank target,
                                     # re-derived each iteration from the
                                     # converged σ spectrum (AMS:463-470); for
                                     # other problem types it stays at the
                                     # static target


@dataclasses.dataclass(frozen=True)
class ProblemKnowledge:
    """Host-side (static) diagnosis results — the immutable half of the reference's
    ``problem_knowledge`` dict, computed once by :mod:`maus_tpu.solver.diagnose`
    (reference ``_diagnose_matrix_initial``, AMS:374-404).

    These are *Python* values decided before tracing: Hermitian-ness selects a whole
    different compiled path (the eigh fast path, AMS:154-221), so it must be static.
    """

    shape: tuple
    is_hermitian: bool = False
    is_complex_symmetric: bool = False
    is_sparse_input: bool = False     # density < 0.25 in the reference (AMS:380)
    is_positive_definite: bool = False  # Hermitian + positive spectrum: unlocks
                                        # the Cholesky solve path (2× cheaper
                                        # than LU)
    density: float = 1.0
    cond_estimate: float = 1.0
    is_singular: bool = False
    effective_rank: Optional[int] = None   # SVD mode (AMS:463-470)

    @property
    def stability(self) -> StabilityState:
        """Initial stability classification (reference AMS:407-416)."""
        if self.is_singular or self.cond_estimate > 1e12:
            return StabilityState.CRITICAL
        if self.cond_estimate > 1e6:
            return StabilityState.FRAGILE
        return StabilityState.STABLE


def default_target_solutions(cfg: SolverConfig, knowledge: ProblemKnowledge) -> int:
    """How many distinct solutions the run is trying to find.

    Reference: eigenproblems target N eigenpairs, linear targets 1, SVD targets the
    effective rank (AMS:528-534, AMS:463-470).
    """
    if cfg.target_num_solutions is not None:
        return int(cfg.target_num_solutions)
    m, n = cfg_shape_mn(knowledge.shape)
    if cfg.problem_type == ProblemType.EIGENVALUE:
        return n
    if cfg.problem_type == ProblemType.SVD:
        if knowledge.effective_rank is not None:
            return int(knowledge.effective_rank)
        return min(m, n)
    return 1


def cfg_shape_mn(shape: tuple) -> tuple:
    m = int(shape[0])
    n = int(shape[1]) if len(shape) > 1 else int(shape[0])
    return m, n


def initial_strategy(cfg: SolverConfig, knowledge: ProblemKnowledge) -> StrategyState:
    """Build the initial :class:`StrategyState` from the static diagnosis.

    Mirrors the reference's ``_set_initial_strategy`` regime table (AMS:406-422):
    Critical → heavy Ψ-aggression + iterative preference + loose threshold;
    Fragile → moderate; Stable → direct + global tolerance.
    """
    f32 = jnp.float32
    stab = knowledge.stability
    # Deviation from the reference's regime table (AMS:407-416), which preferred
    # GMRES for Fragile/Critical: a dense LU is backward-stable at any κ and
    # batches perfectly, while restarted GMRES stalls on dense ill-conditioned
    # operators. DIRECT is therefore the default everywhere; the iterative path is
    # reached via singularity or runtime failover (reference M3e, AMS:98-102).
    if stab == StabilityState.CRITICAL:
        aggression, pref, thresh = 50.0, SolverPreference.DIRECT, max(cfg.tol, 1e-2)
    elif stab == StabilityState.FRAGILE:
        aggression, pref, thresh = 10.0, SolverPreference.DIRECT, max(cfg.tol, 1e-4)
    else:
        aggression, pref, thresh = 1.0, SolverPreference.DIRECT, cfg.tol
    if knowledge.is_singular and cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
        aggression, pref = max(aggression, 20.0), SolverPreference.GMRES
    if cfg.problem_type == ProblemType.SVD:
        aggression = max(aggression, 2.0)
        thresh = max(thresh, 1e-5)
    return StrategyState(
        psi_aggression=jnp.asarray(aggression, f32),
        spawn_rate=jnp.asarray(1.0, f32),
        threshold=jnp.asarray(thresh, f32),
        solver_pref=jnp.asarray(int(pref), jnp.int32),
        stability=jnp.asarray(int(stab), jnp.int32),
        landscape_energy=jnp.asarray(1.0, f32),
        avg_residual=jnp.asarray(jnp.inf, f32),
        avg_stuckness=jnp.asarray(0.0, f32),
        num_distinct=jnp.asarray(0, jnp.int32),
        frustration=jnp.asarray(0.0, f32),
        pref_failures=jnp.asarray(0.0, f32),
        target_dynamic=jnp.asarray(
            min(default_target_solutions(cfg, knowledge), cfg.num_candidates),
            jnp.int32),
    )
