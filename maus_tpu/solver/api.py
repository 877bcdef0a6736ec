"""User-facing API — the device-native equivalent of the reference's ``MAUS_Solver``
class (AMS:340-608) plus functional one-shots (:func:`solve`, :func:`eig`,
:func:`svd`).

Construction mirrors the reference signature
``MAUS_Solver(M, problem_type, b_vector=None, initial_num_candidates=None,
global_convergence_tol=1e-8)`` (AMS:341); ``.evolve(max_iterations)`` runs the
jitted loop and returns a :class:`SolutionReport` of distinct converged solutions
with their residuals (the reference prints a final report, AMS:587-608 — here it's
data).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import backend
from ..core.types import (ProblemKnowledge, ProblemType, SolverConfig,
                          default_target_solutions)
from ..ops.batched_solve import shared_factor_hpd, shared_factor_qr
from ..ops.refine import SplitComplex
from ..ops.refine import refine_split as refine_split_ir
from ..utils.xfer import to_device_complex, to_host_complex
from . import evolve as evolve_mod
from . import strategy as strat_mod
from .diagnose import _to_dense_numpy, diagnose


@dataclasses.dataclass
class SolutionReport:
    """Distinct converged solutions + run diagnostics.

    ``solutions`` entries follow the reference tuple layout
    (``get_current_solution_params``, AMS:333-337): eig → (λ, v); linear → (x,);
    SVD → (σ, u, v).
    """

    problem_type: ProblemType
    solutions: list
    residuals: list
    iterations: int
    num_distinct: int
    target_solutions: int
    landscape_energy: float
    knowledge: ProblemKnowledge
    metrics: Optional[dict] = None

    @property
    def converged(self) -> bool:
        return self.num_distinct >= self.target_solutions

    def best(self):
        if not self.solutions:
            return None
        return self.solutions[int(np.argmin(self.residuals))]


def _device_staging_ok() -> bool:
    """Device-resident operands stage without any host round-trip on
    accelerator backends (separable for tests, which force it on CPU)."""
    return backend.is_accelerator()


@partial(jax.jit, static_argnames=("dtype",))
def _cast_dev(a, dtype):
    return a.astype(dtype)


@jax.jit
def _split_real_dev(a):
    return a.astype(jnp.float64), jnp.zeros_like(a, jnp.float64)


@jax.jit
def _finite_probe_jit(a):
    return jnp.all(jnp.isfinite(a.real)) & jnp.all(jnp.isfinite(a.imag)) \
        if jnp.issubdtype(a.dtype, jnp.complexfloating) \
        else jnp.all(jnp.isfinite(a))


def _finite_probe_dev(a) -> bool:
    return bool(_finite_probe_jit(a))


def _widen_wide_rhs(b_vector):
    """Full-precision split planes of a device rhs whose dtype is WIDER than
    the working dtype (f64 real / c128) — refinement must certify against the
    user's b, not its working-dtype rounding (the host path keeps b_host as
    complex128 for exactly this). Returns None when the working-dtype cast is
    exact (f32/c64 inputs) or x64 is off."""
    dt = b_vector.dtype
    if not jax.config.jax_enable_x64 or dt not in (np.dtype(np.float64),
                                                   np.dtype(np.complex128)):
        return None
    re64, im64 = jax.jit(lambda v: (v.real.astype(jnp.float64),
                                    v.imag.astype(jnp.float64)))(b_vector)
    return SplitComplex(re64, im64)


def _stage_operand(matrix, problem_type: ProblemType, compute_dtype):
    """Shared operand staging for construction AND mid-run swaps
    (``update_problem``, AMS:645-652 — the swap must keep constructor parity:
    one host-to-device transfer, cached full-precision planes, planes-based
    diagnosis).

    On an accelerator a full-precision operand crosses to the device ONCE as
    f64 planes (the c64 compute copy is derived on device and the refinement
    planes are pre-cached); float32/complex64 inputs transfer 4× less and
    widen on device instead.

    Returns ``(A_host, A_dev, prefetched_planes_or_None, input_c64_exact)``.

    DEVICE-RESIDENT inputs (``jax.Array`` on an accelerator backend): the
    operand never touches the host. ``A_host`` comes back ``None``;
    diagnosis, refinement planes, and result assembly all run on device.
    """
    if isinstance(matrix, jax.Array) and not hasattr(matrix, "toarray") \
            and _device_staging_ok():
        if matrix.ndim != 2:
            raise ValueError(f"expected a 2-D operand, got shape "
                             f"{matrix.shape}")
        dt = matrix.dtype
        exact = dt in (np.dtype(np.float32), np.dtype(np.complex64))
        prefetched = None
        if jnp.issubdtype(dt, jnp.complexfloating):
            if dt == np.dtype(np.complex128) and jax.config.jax_enable_x64:
                # wide complex device input: prefetch the full-precision
                # planes so refinement targets the user's operand, not its
                # working-dtype rounding
                prefetched = jax.jit(
                    lambda a: (a.real.astype(jnp.float64),
                               a.imag.astype(jnp.float64)))(matrix)
            A_dev = matrix if dt == compute_dtype \
                else _cast_dev(matrix, compute_dtype)
        elif dt == np.dtype(np.float64) and jax.config.jax_enable_x64:
            # real f64 device input: the f64 plane IS the operand — prefetch
            # it as the refinement planes (imag plane is zero)
            re64, im64 = _split_real_dev(matrix)
            prefetched = (re64, im64)
            A_dev = _cast_dev(matrix, compute_dtype)
        else:
            A_dev = _cast_dev(matrix, compute_dtype)
        fin = _finite_probe_dev(A_dev)
        if not fin:
            raise ValueError("matrix contains non-finite entries")
        if problem_type != ProblemType.SVD and \
                A_dev.shape[0] != A_dev.shape[1]:
            raise ValueError(f"{problem_type.name} requires a square matrix, "
                             f"got {A_dev.shape}")
        return None, A_dev, prefetched, exact

    input_c64_exact = np.dtype(
        getattr(matrix, "dtype", np.complex128)) \
        in (np.dtype(np.float32), np.dtype(np.complex64))
    # The prefetch path transfers the operand's f64 planes ONCE and never
    # reads A_host afterwards (x64 required so the planes can be cached as
    # the refinement operand) — only then is a complex128 input safe to use
    # WITHOUT a defensive host copy
    will_prefetch = backend.is_accelerator() and \
        not input_c64_exact and compute_dtype == jnp.complex64 and \
        jax.config.jax_enable_x64
    A_host = _to_dense_numpy(matrix).astype(np.complex128,
                                            copy=not will_prefetch)
    if not (np.all(np.isfinite(A_host.real)) and
            np.all(np.isfinite(A_host.imag))):
        raise ValueError("matrix contains non-finite entries")
    if problem_type != ProblemType.SVD and A_host.ndim == 2 and \
            A_host.shape[0] != A_host.shape[1]:
        raise ValueError(
            f"{problem_type.name} requires a square matrix, got {A_host.shape}")
    prefetched_A64 = None
    if will_prefetch:
        from ..utils.xfer import c64_from_split_f64, to_device_split_f64
        re64, im64 = to_device_split_f64(A_host)
        A_dev = c64_from_split_f64(re64, im64)
        prefetched_A64 = (re64, im64)
    else:
        A_dev = to_device_complex(A_host, compute_dtype)
    return A_host, A_dev, prefetched_A64, input_c64_exact


def _final_dedup(cfg: SolverConfig, problem_type: ProblemType,
                 solutions: list, residuals: list) -> tuple[list, list]:
    """Deterministic host-side final dedup over the gathered leaders
    (VERDICT r2 #7). The device-side dedup (strategy.compute_diagnostics) can
    flip borderline pairs across XLA recompilations (different fusion →
    ~eps-level value changes right at the similarity thresholds), making
    ``num_distinct`` vary between fresh processes. This pass re-decides with
    HYSTERESIS-BANDED thresholds — the duplicate region is widened by a fixed
    band factor, so pairs the device judged duplicates (at the unwidened
    threshold) sit safely inside the host's duplicate region, and eps-level
    jitter cannot move them across it. Entries are processed in residual
    order (best first), reference similarity rules per class (M5d,
    AMS:435-452)."""
    BAND = 1.25
    order = sorted(range(len(solutions)), key=lambda i: residuals[i])
    vec_dup = 1.0 - BAND * (1.0 - cfg.vector_similarity_tol)
    kept_s, kept_r = [], []

    def _overlap(a, b):
        na = np.linalg.norm(a)
        nb = np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 1.0
        return abs(np.vdot(a, b)) / (na * nb)

    for i in order:
        sol, res = solutions[i], residuals[i]
        dup = False
        for ks, kr in zip(kept_s, kept_r):
            # residual-aware band, mirroring the device rule
            # (strategy._pairwise_same): value noise of backward-stable
            # approximations scales with the achieved residuals
            rband = 4.0 * (res + kr) if np.isfinite(res + kr) else 0.0
            if problem_type == ProblemType.EIGENVALUE:
                lam, v = sol
                lam2, v2 = ks
                dup = (abs(lam - lam2) < BAND * (cfg.lambda_similarity_tol
                                                 + abs(lam2) * 1e-6) + rband
                       and _overlap(v, v2) > vec_dup)
            elif problem_type == ProblemType.SVD:
                sig, u, v = sol
                sig2, u2, v2 = ks
                dup = (abs(sig - sig2) < BAND * (cfg.sigma_similarity_abs
                                                 + abs(sig2)
                                                 * cfg.sigma_similarity_rel)
                       + rband
                       and _overlap(u, u2) > vec_dup
                       and _overlap(v, v2) > vec_dup)
            else:
                dup = bool(np.linalg.norm(sol[0] - ks[0])
                           < BAND * 100.0 * cfg.tol)
            if dup:
                break
        if not dup:
            kept_s.append(sol)
            kept_r.append(res)
    return kept_s, kept_r


@jax.jit
def _host_refactor_hpd(A, psi):
    with jax.default_matmul_precision("highest"):
        return shared_factor_hpd(A, psi)


@jax.jit
def _host_refactor_qr(A, psi):
    with jax.default_matmul_precision("highest"):
        return shared_factor_qr(A, psi)


def _host_refactor_program(A, psi, hpd: bool):
    """Rebuild the shared linear factorization as its OWN compiled program
    (SolverConfig.host_refactor): under a branch memory cap
    (``backend.branch_memory_cap()``) a large QR is refused inside the evolve
    loop's lax.cond but compiles at program top level."""
    return _host_refactor_hpd(A, psi) if hpd else _host_refactor_qr(A, psi)


# Hoist the eig path's one-time Hessenberg reduction out of the evolve-loop
# program at and past this operand size; 8192² is the largest size at which
# the in-loop reduction has run (chosen before the GPU port, not measured on
# the H100 — ROADMAP S7).
_HESS_HOIST_MIN_N = 12288


@jax.jit
def _host_hessenberg_program(A):
    """One-time shared Hessenberg reduction A = Q H Qᴴ as its OWN compiled
    program — the eig analogue of the linear path's hoisted QR: its temps
    are not stacked on the evolve-loop program's."""
    from ..ops.hessenberg import reduce_hessenberg_auto
    with jax.default_matmul_precision("highest"):
        return reduce_hessenberg_auto(A)


def _fac_all_finite(fac) -> bool:
    """True iff every array leaf of a factorization pytree is finite.

    A declared-HPD operand with an indefinite defect leaves NaN Cholesky
    factors in the evolve carry whenever the run's final Ψ rung decayed back
    below |λ_min| (the engine itself survives via the direct→GMRES failover,
    so frustration can read 0.0 at exit) — those factors must never seed the
    refinement cache. One jitted device reduction; bytes-bound, so cheap even
    for multi-GB factors."""
    leaves = [l for l in jax.tree.leaves(fac) if hasattr(l, "dtype")]
    if not leaves:
        return True

    @jax.jit
    def _prog(ls):
        ok = jnp.asarray(True)
        for l in ls:
            if jnp.issubdtype(l.dtype, jnp.floating) or \
                    jnp.issubdtype(l.dtype, jnp.complexfloating):
                ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(l)))
        return ok

    return bool(_prog(leaves))


def resolve_refactor_carry(A, carry, hpd: bool = False):
    """ONE implementation of the host-refactor handoff protocol, shared by
    ``MausSolver`` and the bench/probe drivers: when the evolve loop exited
    with ``carry.refactor_psi`` set, rebuild the shared factorization at that
    Ψ in a standalone program and return the carry ready for re-entry;
    ``None`` when no refactorization is pending."""
    rp = float(carry.refactor_psi)
    if rp == 0.0:
        return None
    # Free the STALE factors' device buffers before the rebuild (at 16384²
    # Q,R are 4.3 GB, held next to the rebuild's own Q,R + workspace + A
    # otherwise). Ownership contract: the caller's carry is dead after a
    # non-None return (the hosted drivers re-enter with the returned carry
    # and never read the old one's fac again).
    stale = carry.fac
    carry = carry._replace(fac=None)
    if stale is not None:
        for leaf in jax.tree.leaves(stale):
            if hasattr(leaf, "delete"):
                leaf.delete()
    fac = _host_refactor_program(A, jnp.asarray(rp, jnp.float32), hpd)
    return carry._replace(fac=fac,
                          psi_cached=jnp.asarray(rp, jnp.float32),
                          refactor_psi=jnp.zeros((), jnp.float32))


class MausSolver:
    """Population-based meta-heuristic matrix solver (device-native MAUS)."""

    def __init__(self, matrix, problem_type: ProblemType, b_vector=None,
                 initial_num_candidates: Optional[int] = None,
                 global_convergence_tol: float = 1e-8,
                 config: Optional[SolverConfig] = None, seed: int = 0,
                 knowledge: Optional[ProblemKnowledge] = None,
                 target_solutions: Optional[int] = None):
        """``target_solutions``: how many distinct solutions to search for
        (defaults per problem type). Oversubscribing candidates relative to
        it — the reference runs 30 candidates for 8 eigenpair targets
        (AMS:654-657) — absorbs shift collisions on dense spectra."""
        problem_type = ProblemType(problem_type)
        self._target_override = target_solutions
        from ..utils.compile_cache import enable_once
        enable_once()   # persistent compile cache on the GPU (no-op on CPU;
        #                 opt out with MAUS_NO_COMPILE_CACHE=1)
        # Compute dtype is decided before diagnosis so the operand can move to
        # the device first — the condition estimate then runs on device for
        # large N (estimate_cond_device) instead of stalling on host LAPACK.
        # The x64 flag alone does not select c128: the GPU runs with x64 ON
        # for split-f64 refinement while complex compute stays c64.
        use_c128 = backend.default_complex_dtype() == jnp.complex128
        if config is not None:
            compute_dtype = config.dtype
        else:
            compute_dtype = backend.default_complex_dtype()
        A_host, A_dev, _prefetched_A64, input_c64_exact = _stage_operand(
            matrix, problem_type, compute_dtype)
        # callers who already know the operand's structure (e.g. the bench harness
        # generating a matrix with prescribed κ) may skip the O(N³-ish) diagnosis.
        # Diagnose the ORIGINAL operand — densifying first would lose the
        # sparse-input classification (AMS:380 semantics).
        self.knowledge = knowledge if knowledge is not None \
            else diagnose(matrix if A_host is not None else None,
                          problem_type, device_operand=A_dev,
                          device_planes=_prefetched_A64,
                          device_exact=input_c64_exact)
        m, n = self.knowledge.shape

        if config is None:
            # reference default population: 3N, SVD ≥ 3·min(M,N) (AMS:365-367),
            # clamped to 64
            if initial_num_candidates is None:
                initial_num_candidates = min(3 * max(m, n), 64)
            # dtype-aware convergence floor: c64 relative residuals bottom out
            # around max(√N, κ)·eps_f32; the refinement pass recovers the rest.
            # κ-awareness matters on hardware: a κ=1e3 system's best c64
            # residual is ~1e-4 — a flat 50·eps floor would never be reached
            # and the loop would stall to the limit instead of handing off to
            # refinement (caught by the hardware test tier). The cap is 1 (a
            # candidate better than x = 0): a lower cap sits below the c64
            # floor 2·κ·ε_f32 once κ ≳ 4e4, so no candidate ever converged
            # and the report came back empty (κ = 1e6 on the GPU).
            dt = compute_dtype
            eps32 = float(np.finfo(np.float32).eps)
            cond = self.knowledge.cond_estimate
            cond = cond if np.isfinite(cond) else 1e15
            if use_c128:
                floor = 0.0
            elif problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
                floor = float(min(max(50.0, 2.0 * cond) * eps32, 1.0))
            else:
                # eig/SVD: the c64 eigen/triplet residual floor is ~√N·ε·‖A‖
                # — κ-INDEPENDENT (κ·ε is the floor of linear relative
                # residuals only). The κ-aware bound loosened the acceptance
                # to ~1e-2 on ill-conditioned spectra, freezing crude vectors
                # that the finisher then snapped onto shared eigenpairs (the
                # collision path _adapt_and_classify's tight acceptance
                # exists to prevent); matches _spectral_floor (mesh paths).
                floor = float(min(max(50.0, np.sqrt(max(m, n))) * eps32,
                                  1e-2))
            config = SolverConfig(problem_type=problem_type,
                                  num_candidates=int(initial_num_candidates),
                                  tol=float(global_convergence_tol),
                                  dtype=dt, convergence_floor=floor)
        else:
            config = dataclasses.replace(
                config, problem_type=problem_type,
                tol=float(global_convergence_tol) if global_convergence_tol != 1e-8
                else config.tol)
            if initial_num_candidates is not None:
                config = dataclasses.replace(
                    config, num_candidates=int(initial_num_candidates))
        self._host_refactor_explicit = config.host_refactor is not None
        if config.host_refactor is None:
            # auto: host-driven refactorization only where the backend needs
            # it (backend.needs_host_refactor; see SolverConfig.host_refactor)
            config = dataclasses.replace(
                config, host_refactor=(
                    problem_type == ProblemType.SOLVE_LINEAR_SYSTEM
                    and backend.needs_host_refactor(n)))
        self.config = config
        if self._target_override is not None:
            self.config = config = dataclasses.replace(
                config, target_num_solutions=int(self._target_override))
        self.target_solutions = min(
            default_target_solutions(config, self.knowledge), config.num_candidates)

        self.A_host = A_host
        if config.dtype == compute_dtype:
            self.A = A_dev
        elif A_host is not None:
            self.A = to_device_complex(A_host, config.dtype)
        else:
            self.A = _cast_dev(A_dev, jnp.dtype(config.dtype))
        self.b = None
        self.b_host = None
        self._b64_dev = None   # wide device rhs planes (see _widen_wide_rhs)
        if problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            if b_vector is None:
                raise ValueError("SOLVE_LINEAR_SYSTEM requires b_vector")
            if isinstance(b_vector, jax.Array) and _device_staging_ok():
                # device-resident rhs: stays on device
                if b_vector.shape != (n,):
                    raise ValueError(f"b_vector shape {b_vector.shape} does "
                                     f"not match matrix ({n},)")
                self._b64_dev = _widen_wide_rhs(b_vector)
                self.b = _cast_dev(b_vector, jnp.dtype(config.dtype))
                if not _finite_probe_dev(self.b):
                    raise ValueError("b_vector contains non-finite entries")
            else:
                self.b_host = np.asarray(b_vector).astype(np.complex128)
                if self.b_host.shape != (n,):
                    raise ValueError(f"b_vector shape {self.b_host.shape} "
                                     f"does not match matrix ({n},)")
                if not (np.all(np.isfinite(self.b_host.real)) and
                        np.all(np.isfinite(self.b_host.imag))):
                    raise ValueError("b_vector contains non-finite entries")
                self.b = to_device_complex(self.b_host, config.dtype)
        self._key = jax.random.PRNGKey(seed)
        self._fac_cache = None
        self._hess_hoist = None   # standalone-program Hessenberg (large-N eig)
        # float32/complex64 user input: the c64 device copy already carries
        # every bit — refinement planes can be derived on device, no transfer
        self._input_c64_exact = input_c64_exact
        self._A64_cache = None
        if _prefetched_A64 is not None and jax.config.jax_enable_x64:
            self._A64_cache = SplitComplex(*_prefetched_A64)

    # -- reference parity: allow swapping the operand mid-run (scenario 1 does
    # this, AMS:645-652) ---------------------------------------------------------
    def update_problem(self, matrix=None, b_vector=None):
        if matrix is not None:
            # full constructor parity (VERDICT r2 #8): the swap goes through
            # the SAME staging (one transfer, prefetched f64 planes)
            # and the SAME planes-based diagnosis, so a large swapped
            # Hermitian operand keeps the shared-eigh fast path and the
            # cached refinement planes instead of degrading to the
            # c64-copy classify-as-general branch.
            A_host, A_dev, planes, exact = _stage_operand(
                matrix, self.config.problem_type, self.config.dtype)
            self.A_host = A_host
            self.A = A_dev
            self._input_c64_exact = exact
            self.knowledge = diagnose(
                matrix if A_host is not None else None,
                self.config.problem_type, device_operand=A_dev,
                device_planes=planes, device_exact=exact)
            self.target_solutions = min(
                default_target_solutions(self.config, self.knowledge),
                self.config.num_candidates)
            # re-resolve the AUTO host-refactor policy (a swap can cross the
            # size threshold); an explicit user setting is never overridden
            if not self._host_refactor_explicit:
                self.config = dataclasses.replace(
                    self.config, host_refactor=(
                        self.config.problem_type
                        == ProblemType.SOLVE_LINEAR_SYSTEM
                        and backend.needs_host_refactor(
                            self.knowledge.shape[-1])))
            self._A64_cache = None
            if planes is not None and jax.config.jax_enable_x64:
                self._A64_cache = SplitComplex(*planes)
        if b_vector is not None:
            if isinstance(b_vector, jax.Array) and _device_staging_ok():
                if self.config.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM \
                        and b_vector.shape != (self.knowledge.shape[-1],):
                    raise ValueError(
                        f"b_vector shape {b_vector.shape} does not match "
                        f"matrix ({self.knowledge.shape[-1]},)")
                self.b_host = None
                self._b64_dev = _widen_wide_rhs(b_vector)
                self.b = _cast_dev(b_vector, jnp.dtype(self.config.dtype))
            else:
                self.b_host = np.asarray(b_vector).astype(np.complex128)
                self._b64_dev = None
                if self.config.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM \
                        and self.b_host.shape != (self.knowledge.shape[-1],):
                    raise ValueError(
                        f"b_vector shape {self.b_host.shape} does not match "
                        f"matrix ({self.knowledge.shape[-1]},)")
                self.b = to_device_complex(self.b_host, self.config.dtype)
        self._fac_cache = None
        self._hess_hoist = None

    def evolve(self, max_iterations: int = 100,
               collect_metrics: bool = False,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               reopen: bool = False) -> SolutionReport:
        """Run the evolution loop.

        ``resume_from`` restores a carry saved by a previous ``checkpoint_path``
        run (same config/shapes) and continues from there — the whole solver
        state is one pytree, so resume is just re-entering the jitted loop
        (SURVEY.md §5.4; the reference has no serialization at all).

        ``checkpoint_every=k`` saves the carry to ``checkpoint_path`` every k
        iterations (in-loop periodic checkpointing, SURVEY §5.4): the run
        executes as chunks of k iterations of the same jitted loop, so a
        resumed run reproduces the uninterrupted one bit-exactly.

        ``reopen=True`` resumes a checkpoint written BEFORE an
        ``update_problem`` swap: the restored carry's convergence bookkeeping
        (converged candidates, distinct count, stall counter) refers to the
        old operand and is reset so the population re-evaluates against the
        current one (scenario-1 swap semantics, AMS:645-652).
        """
        cfg, kn = self.config, self.knowledge
        carry0 = None
        if resume_from is not None:
            carry0 = _load_resume_carry(
                cfg, kn, self.A, self._key, resume_from, reopen,
                refactor=lambda psi: _host_refactor_program(
                    self.A, psi, hpd=bool(kn.is_positive_definite)))
        if checkpoint_every is not None:
            if checkpoint_path is None:
                raise ValueError("checkpoint_every requires checkpoint_path")
            carry, metrics = self._evolve_chunked(
                max_iterations, collect_metrics, checkpoint_path,
                int(checkpoint_every), carry0)
        elif collect_metrics:
            carry, metrics = self._scan_hosted(max_iterations, carry0)
        else:
            carry, metrics = self._while_hosted(max_iterations, carry0)
            metrics = None   # while-path metrics are last-iteration only
        if checkpoint_path is not None:
            from ..utils.checkpoint import save_state
            save_state(checkpoint_path, carry)

        if cfg.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM and \
                carry.fac is not None and self._fac_cache is None:
            # reuse the evolve loop's carried factorization as refinement's
            # correction-solve preconditioner instead of building a second
            # O(N³) QR — but ONLY
            # while its Ψ shift is provably harmless: IR contracts per step
            # by an extra ψ/(σ_min+ψ), so require ψ ≲ 1e-3·σ_min, i.e.
            # aggression·psi_base ≤ 1e-3/κ with zero frustration rungs (a
            # frustrated run's ψ approaches ε·‖A‖ and would stall refinement
            # where a fresh psi_base QR converges).
            cond_k = self.knowledge.cond_estimate
            cond_k = float(cond_k) if np.isfinite(cond_k) else 1e15
            aggr_cap = max(1.5, 1e-3 / (cfg.psi_base * cond_k))
            if float(carry.strat.frustration) == 0.0 and \
                    float(carry.strat.psi_aggression) <= aggr_cap and \
                    _fac_all_finite(carry.fac):
                # the finiteness gate matters for declared-HPD operands with
                # an indefinite defect: the carried Cholesky is NaN whenever
                # the final Ψ rung sits below |λ_min|, and a NaN preconditioner
                # makes IR and GMRES-IR silently return inf; refinement then
                # falls back to a fresh psi_base QR in _refine_linear
                self._fac_cache = carry.fac

        pop, strat = carry.pop, carry.strat
        if cfg.problem_type == ProblemType.SVD:
            # the run's final view of the effective rank (re-derived on device
            # from the converged σ spectrum, AMS:463-470) supersedes the
            # initial host estimate
            self.target_solutions = int(strat.target_dynamic)
        diag = strat_mod.compute_diagnostics(cfg, pop, strat, self.target_solutions)
        leader = np.asarray(diag.distinct_leader)
        residual = np.array(pop.residual)   # writable copy (refinement updates it)
        v = to_host_complex(pop.v)
        lam = to_host_complex(pop.lam)
        u = None if pop.u is None else to_host_complex(pop.u)

        solutions, residuals = [], []
        order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
        leader_ks = [int(k) for k in order if leader[k]]
        refined = {}
        if cfg.refine and leader_ks and cfg.problem_type in (
                ProblemType.EIGENVALUE, ProblemType.SVD):
            # mixed-precision finisher (ops/refine_eig.py): in c64 the
            # evolve loop accepts at the dtype floor ≈ √N·ε_f32; this closes
            # the gap to the user's tol with f64 split-plane Newton steps —
            # the eig/SVD analogue of _refine_linear (AMS:25 tol contract)
            refined = self._refine_spectral(leader_ks, lam, v, u, residual)
        for k in leader_ks:
            if cfg.problem_type == ProblemType.EIGENVALUE:
                lam_k, v_k, r_k = refined.get(
                    k, (complex(lam[k]), v[k], float(residual[k])))
                solutions.append((lam_k, v_k))
                residuals.append(r_k)
            elif cfg.problem_type == ProblemType.SVD:
                s_k, u_k, v_k, r_k = refined.get(
                    k, (float(lam[k].real), u[k], v[k], float(residual[k])))
                solutions.append((s_k, u_k, v_k))
                residuals.append(r_k)
            else:
                xk = v[k]
                if cfg.refine:
                    xk, rel = self._refine_linear(xk)
                    residual[k] = float(rel)
                solutions.append((xk,))
                residuals.append(float(residual[k]))

        # deterministic final dedup (VERDICT r2 #7): num_distinct is decided
        # HERE, with hysteresis-banded thresholds, not by the device pass
        solutions, residuals = _final_dedup(cfg, cfg.problem_type,
                                            solutions, residuals)
        mdict = _metrics_dict(metrics)
        return SolutionReport(
            problem_type=cfg.problem_type, solutions=solutions, residuals=residuals,
            iterations=int(carry.iteration), num_distinct=len(solutions),
            target_solutions=self.target_solutions,
            landscape_energy=float(strat.landscape_energy), knowledge=kn,
            metrics=mdict)

    # -- host-mediated refactorization (SolverConfig.host_refactor) ------------
    def _resolve_refactor(self, carry):
        """If the evolve loop exited asking for a refactorization
        (``carry.refactor_psi != 0``), rebuild the shared factorization in a
        STANDALONE program (see :func:`_host_refactor_program`) and return
        the carry ready for re-entry. Returns None when no refactorization
        is pending."""
        return resolve_refactor_carry(
            self.A, carry, hpd=bool(self.knowledge.is_positive_definite))

    def _hoisted_hessenberg(self):
        """Pre-built shared Hessenberg form for LARGE-N general eig, or None.

        At N ≥ ``_HESS_HOIST_MIN_N`` the blocked reduction is built as its
        own standalone program (``_host_hessenberg_program``) and passed into
        the evolve loop as data (``hess0=``). Built lazily once and cached;
        invalidated by ``update_problem``."""
        cfg, kn = self.config, self.knowledge
        if not (cfg.problem_type == ProblemType.EIGENVALUE
                and evolve_mod._use_hessenberg(cfg, kn)
                and kn.shape[-1] >= _HESS_HOIST_MIN_N):
            return None
        if self._hess_hoist is None:
            self._hess_hoist = _host_hessenberg_program(self.A)
        return self._hess_hoist

    def _while_hosted(self, max_iterations: int, carry0):
        """evolve_while + host-refactor resolution loop."""
        cfg, kn = self.config, self.knowledge
        hess0 = self._hoisted_hessenberg()
        if carry0 is None and cfg.host_refactor:
            # build the initial carry (the one-time large QR) in its OWN
            # program: inlined into the while-loop program its peak stacks on
            # the double-buffered Q,R carry
            carry0 = evolve_mod.init_carry(cfg, kn, self.A, self._key)
        seen_handoffs = set()
        while True:
            carry, metrics = evolve_mod.evolve_while(
                cfg, kn, self.A, self.b, self._key, max_iterations,
                self.target_solutions, carry0=carry0, hess0=hess0)
            nxt = self._resolve_refactor(carry)
            if nxt is None:
                return carry, metrics
            # progress guard: every re-entry must advance the iteration
            # counter or request a DIFFERENT Ψ at it. A repeated
            # (iteration, Ψ) handoff means the pure-recomputation assumption
            # broke (the bug class this detects) and the loop would spin
            # forever rebuilding the same factorization.
            handoff = (int(carry.iteration), float(carry.refactor_psi))
            if handoff in seen_handoffs:
                raise RuntimeError(
                    "host refactorization loop made no progress (repeated "
                    f"handoff at iteration {handoff[0]}, Ψ={handoff[1]:g}) — "
                    "this is a bug, please report")
            seen_handoffs.add(handoff)
            carry0 = nxt

    def _scan_hosted(self, num_iterations: int, carry0):
        """evolve_scan + host-refactor resolution. Every re-entry uses the
        SAME static scan length plus a traced total-iteration bound, so the
        whole hosted run costs one compiled program; metric chunks are
        trimmed to their executed rows and concatenated — identical rows
        (including trailing frozen zero-rows) to a single uninterrupted
        scan."""
        import jax as _jax
        cfg, kn = self.config, self.knowledge
        hess0 = self._hoisted_hessenberg()
        if carry0 is None and cfg.host_refactor:
            # see _while_hosted: keep the one-time QR out of the loop program
            carry0 = evolve_mod.init_carry(cfg, kn, self.A, self._key)
        start0 = 0 if carry0 is None else int(carry0.iteration)
        bound = jnp.asarray(start0 + num_iterations, jnp.int32)
        chunks = []
        seen_handoffs = set()
        while True:
            start_iter = 0 if carry0 is None else int(carry0.iteration)
            carry, m = evolve_mod.evolve_scan(
                cfg, kn, self.A, self.b, self._key, num_iterations,
                self.target_solutions, carry0=carry0, iteration_bound=bound,
                hess0=hess0)
            nxt = self._resolve_refactor(carry)
            if nxt is None:
                # final chunk: keep exactly the rows this entry was
                # responsible for (rows past them are bound-frozen zeros)
                keep = num_iterations - (start_iter - start0)
                chunks.append(_jax.tree.map(lambda x: x[:keep], m))
                break
            # the flagged iteration froze itself and everything after it:
            # keep only the rows that actually executed; the rest re-run
            # (post-refactor) in the next chunk, so total rows stay exact
            done = int(carry.iteration) - start_iter
            chunks.append(_jax.tree.map(lambda x: x[:done], m))
            handoff = (int(carry.iteration), float(carry.refactor_psi))
            if handoff in seen_handoffs:
                raise RuntimeError(
                    "host refactorization loop made no progress (repeated "
                    f"handoff at iteration {handoff[0]}, Ψ={handoff[1]:g}) — "
                    "this is a bug, please report")
            seen_handoffs.add(handoff)
            carry0 = nxt
        if len(chunks) == 1:
            return carry, chunks[0]
        metrics = _jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                                *chunks)
        return carry, metrics

    def _evolve_chunked(self, max_iterations: int, collect_metrics: bool,
                        checkpoint_path: str, every: int, carry0):
        """Run the loop in chunks of ``every`` iterations, saving the carry at
        each boundary. Chunk boundaries fall on iteration boundaries of the
        same jitted step function, so the trajectory is identical to an
        uninterrupted run."""
        import jax as _jax

        from ..utils.checkpoint import save_state
        cfg, kn = self.config, self.knowledge
        carry = carry0
        metrics_chunks = []
        start = 0 if carry is None else int(carry.iteration)
        bound = start
        while bound < max_iterations:
            bound = min(bound + every, max_iterations)
            if collect_metrics:
                carry, m = self._scan_hosted(
                    bound - (0 if carry is None else int(carry.iteration)),
                    carry)
                metrics_chunks.append(m)
            else:
                carry, m = self._while_hosted(bound, carry)
            save_state(checkpoint_path, carry)
            # mirror the in-loop stop: SVD runs re-derive the distinct target
            # dynamically from the converged σ spectrum (AMS:463-470)
            tgt = int(carry.strat.target_dynamic) \
                if cfg.problem_type == ProblemType.SVD else self.target_solutions
            # mirror evolve._stop_condition EXACTLY (SVD: dynamic target
            # alone) so chunked runs stop where uninterrupted ones do
            if int(carry.strat.num_distinct) >= tgt \
                    or int(carry.stall_count) >= cfg.stall_limit:
                break
        if carry is None:   # max_iterations == 0 degenerate case
            carry = evolve_mod.init_carry(cfg, kn, self.A, self._key)
        if collect_metrics and metrics_chunks:
            stacked = _jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0), *metrics_chunks)
            return carry, stacked
        return carry, None

    def _get_A64(self) -> SplitComplex:
        """Device-resident full-precision split planes of the ORIGINAL operand,
        built once and cached, so refinement calls never re-transfer them."""
        if self._A64_cache is None:
            rdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            if self.A_host is not None and not backend.is_accelerator():
                self._A64_cache = SplitComplex(
                    jnp.asarray(self.A_host.real.astype(rdt)),
                    jnp.asarray(self.A_host.imag.astype(rdt)))
            elif self._input_c64_exact or self.A_host is None:
                # widen the existing c64 device copy — exact for c64/f32
                # inputs, and for a device-resident operand the device copy
                # IS the best available data (no host original exists)
                widen = jax.jit(lambda a: (a.real.astype(rdt),
                                           a.imag.astype(rdt)))
                re64, im64 = widen(self.A)
                self._A64_cache = SplitComplex(re64, im64)
            else:
                from ..utils.xfer import to_device_split_f64
                re64, im64 = to_device_split_f64(self.A_host)
                self._A64_cache = SplitComplex(re64.astype(rdt),
                                               im64.astype(rdt))
        return self._A64_cache

    # chunk size for batched spectral refinement: fixed so each distinct
    # (chunk, N) shape compiles once
    _REFINE_CHUNK = 8            # cap; see _refine_chunk for the N-aware rule
    # share of device memory the chunk's factorization workspace may take
    # (2 GiB of the 15.75 GB device the rule was first sized on)
    _REFINE_CHUNK_SHARE = 0.136

    def _refine_chunk(self) -> int:
        """Spectral-refinement batch size, sized to the memory the chunk
        actually allocates: each candidate's Newton step factorizes its own
        (N, N) shifted system, so a chunk holds ≈ CH·N²·itemsize of
        factorization workspace next to the operand and its f64 planes.
        Bound the workspace at ``_REFINE_CHUNK_SHARE`` of device memory and
        let CH shrink with N (floor 1: refinement then streams candidates)."""
        n = max(self.knowledge.shape)
        itemsize = jnp.dtype(self.config.dtype).itemsize
        budget = int(self._REFINE_CHUNK_SHARE * backend.device_memory_bytes())
        if backend.branch_memory_cap() and n > 4096:
            # refine_eig._percand_shifted_solver factors via QR there: Q and R
            # double the per-candidate factor storage, so halve the budget
            budget //= 2
        by_mem = max(int(budget // (n * n * itemsize)), 1)
        return min(self._REFINE_CHUNK, by_mem)

    def _refine_spectral(self, ks: list, lam: np.ndarray, v: np.ndarray,
                         u: Optional[np.ndarray], residual: np.ndarray) -> dict:
        """Batch-refine eigenpair / singular-triplet leaders to f64 residuals
        against the ORIGINAL full-precision operand. Returns {slot: refined
        tuple + residual}, keeping a slot's original data when refinement did
        not improve it."""
        from ..ops.refine_eig import refine_eigenpairs, refine_svd_triplets
        cfg = self.config
        out = {}
        CH = self._refine_chunk()
        A64 = self._get_A64()
        for i in range(0, len(ks), CH):
            chunk = ks[i:i + CH]
            idx = chunk + [chunk[-1]] * (CH - len(chunk))   # pad to fixed shape
            lam_j = to_device_complex(lam[idx], cfg.dtype)
            V_j = to_device_complex(v[idx], cfg.dtype)
            if cfg.problem_type == ProblemType.EIGENVALUE:
                lam_s, V_s, res = refine_eigenpairs(A64, lam_j, V_j, steps=5)
                lam_re, lam_im = np.asarray(lam_s.re), np.asarray(lam_s.im)
                v_re, v_im = np.asarray(V_s.re), np.asarray(V_s.im)
                res_h = np.asarray(res)
                for j, k in enumerate(chunk):
                    if np.isfinite(res_h[j]) and res_h[j] < residual[k]:
                        out[k] = (complex(lam_re[j] + 1j * lam_im[j]),
                                  (v_re[j] + 1j * v_im[j]).astype(np.complex128),
                                  float(res_h[j]))
            else:   # SVD
                U_j = to_device_complex(u[idx], cfg.dtype)
                sig, U_s, V_s, res = refine_svd_triplets(A64, lam_j, U_j, V_j,
                                                         steps=5)
                sig_h = np.asarray(sig)
                u_re, u_im = np.asarray(U_s.re), np.asarray(U_s.im)
                v_re, v_im = np.asarray(V_s.re), np.asarray(V_s.im)
                res_h = np.asarray(res)
                for j, k in enumerate(chunk):
                    if np.isfinite(res_h[j]) and res_h[j] < residual[k]:
                        out[k] = (float(sig_h[j]),
                                  (u_re[j] + 1j * u_im[j]).astype(np.complex128),
                                  (v_re[j] + 1j * v_im[j]).astype(np.complex128),
                                  float(res_h[j]))
        if cfg.problem_type == ProblemType.EIGENVALUE:
            self._escalate_eig_stragglers(ks, lam, v, residual, out, A64, CH)
        return out

    def _escalate_eig_stragglers(self, ks, lam, v, residual, out, A64,
                                 CH: int) -> None:
        """Small-ψ escalation for eigenpairs still above tol after the
        standard rounds: the default ψ regularization perturbs the Newton
        Jacobian, which stalls pseudospectrally ill-conditioned pairs of
        NON-NORMAL operands at O(ψ·non-normality) (measured N=4096 Ginibre:
        3/16 stall at 6e-5..8e-5 with psi_rel=3e-6; psi_rel=1e-10 converges
        all three to ≤1.2e-13; an exact ψ=0 f64 bordered solve converges
        quadratically from the stuck state). refine_eigenpairs' own ψ
        continuation handles this in-band; this host-side gather catches
        candidates whose round-0 stall left them just above tol — only the
        stragglers pay the extra factorizations. Mutates ``out``."""
        from ..ops.refine_eig import refine_eigenpairs
        cfg = self.config
        tol_eff = max(cfg.tol, 0.0)

        def best_res(k):
            return out[k][2] if k in out else float(residual[k])

        fail = [k for k in ks if not (np.isfinite(best_res(k))
                                      and best_res(k) <= tol_eff)]
        if not fail:
            return
        lam_best = np.array([complex(out[k][0]) if k in out else complex(lam[k])
                             for k in fail])
        v_best = np.stack([out[k][1] if k in out else v[k] for k in fail])
        for i in range(0, len(fail), CH):
            chunk = fail[i:i + CH]
            idx = list(range(i, i + len(chunk)))
            idx = idx + [idx[-1]] * (CH - len(idx))     # pad to fixed shape
            lam_j = to_device_complex(lam_best[idx], cfg.dtype)
            V_j = to_device_complex(v_best[idx], cfg.dtype)
            lam_s, V_s, res = refine_eigenpairs(A64, lam_j, V_j, steps=5,
                                                psi_rel=1e-10)
            lam_re, lam_im = np.asarray(lam_s.re), np.asarray(lam_s.im)
            v_re, v_im = np.asarray(V_s.re), np.asarray(V_s.im)
            res_h = np.asarray(res)
            for j, k in enumerate(chunk):
                if np.isfinite(res_h[j]) and res_h[j] < best_res(k):
                    out[k] = (complex(lam_re[j] + 1j * lam_im[j]),
                              (v_re[j] + 1j * v_im[j]).astype(np.complex128),
                              float(res_h[j]))

    def _refine_linear(self, x: np.ndarray):
        """Mixed-precision iterative refinement of a linear solution (O(N²) f64
        residual work against the cached c64 factorization).

        Returns the refined iterate as host complex128 — materializing it in the
        device compute dtype would throw away exactly the digits refinement earned.
        """
        cfg = self.config
        if self._fac_cache is None:
            self._fac_cache = shared_factor_qr(self.A, cfg.psi_base)
        x_j = to_device_complex(x, cfg.dtype)
        # refine against the ORIGINAL full-precision operands (split f64), so
        # the result solves the user's system, not its c64 rounding. The A
        # planes are transferred once and cached (_get_A64); b is small.
        rdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if self.b_host is not None:
            b_split = SplitComplex(jnp.asarray(self.b_host.real.astype(rdt)),
                                   jnp.asarray(self.b_host.imag.astype(rdt)))
        elif self._b64_dev is not None:
            # the user's rhs was WIDER than the working dtype: certify
            # against its prefetched full-precision planes
            b_split = self._b64_dev
        else:
            # device-resident rhs in the working dtype: widening is exact
            b_split = SplitComplex(*jax.jit(
                lambda v: (v.real.astype(rdt), v.imag.astype(rdt)))(self.b))
        A_split = self._get_A64()
        xs, rel = refine_split_ir(A_split, self._fac_cache, b_split, x_j,
                                  steps=cfg.max_refine_steps,
                                  tol=cfg.tol * 0.3)
        if float(rel) > cfg.tol:
            # plain IR stalled (κ·ε_f32 near 1): escalate to GMRES-IR — the
            # factorization becomes a preconditioner instead of the solver
            from ..ops.refine import refine_gmres

            xs2, rel2 = refine_gmres(A_split, self._fac_cache, b_split,
                                     xs.to_complex(cfg.dtype),
                                     steps=cfg.max_refine_steps,
                                     tol=cfg.tol * 0.3)
            if float(rel2) < float(rel):
                xs, rel = xs2, rel2
        x128 = np.asarray(xs.re, np.float64) + 1j * np.asarray(xs.im, np.float64)
        return x128, float(rel)


# ---------------------------------------------------------------------------
# Functional one-shots
# ---------------------------------------------------------------------------

def solve(A, b, tol: float = 1e-8, max_iterations: int = 100,
          num_candidates: Optional[int] = None, seed: int = 0,
          config: Optional[SolverConfig] = None,
          mesh=None, checkpoint_path: Optional[str] = None,
          resume_from: Optional[str] = None,
          checkpoint_every: Optional[int] = None) -> SolutionReport:
    """Solve Ax = b.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``model`` axis of size > 1 —
    the FULL population meta-heuristic (Ψ ladder, α adaptation, strategy
    regimes, retire/respawn) then runs with the shared factorization
    column-sharded over the mesh (:func:`maus_tpu.parallel.dist_qr.dist_qr`
    inside the evolve carry), followed by split-f64 refinement whose
    correction solves reuse the sharded factors — operands larger than one
    device's factorization memory solve in place with the same engine.

    ``checkpoint_path`` / ``resume_from`` / ``checkpoint_every`` work on both
    the single-chip path (via :meth:`MausSolver.evolve`) and the mesh path
    (sharded carry leaves — including the DistQR factors — are saved and
    restored WITH their shardings; SURVEY §5.4).
    """
    if mesh is not None and _mesh_model_size(mesh) > 1:
        return _solve_mesh(A, b, mesh, tol, max_iterations, num_candidates,
                           seed, config, checkpoint_path=checkpoint_path,
                           resume_from=resume_from,
                           checkpoint_every=checkpoint_every)
    s = MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed)
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


def _solve_mesh(A, b, mesh, tol, max_iterations, num_candidates, seed,
                config, checkpoint_path=None, resume_from=None,
                checkpoint_every=None, reopen: bool = False,
                staged=None, collect_metrics: bool = False) -> SolutionReport:
    """Linear solve over a mesh: the FULL engine with the shared factorization
    column-sharded, driven through the checkpoint/resume-capable hosted loop
    (:func:`_mesh_hosted_drive`), then distributed split-f64 refinement.

    ``staged``: pre-staged ``(A_dev, b_dev, Are, Aim, bre, bim)`` from
    :func:`maus_tpu.parallel.dist_qr.stage_operands` (MeshSolver stages once
    at construction/swap and keeps the ORIGINAL-precision planes — re-staging
    from the downcast compute copy would make refinement certify the c64
    rounding instead of the user's system)."""
    from ..parallel.dist_qr import (refine_distributed, stage_operands,
                                    use_dist_sliced)

    if staged is not None:
        A_dev, b_dev, Are, Aim, bre, bim = staged
        n = A_dev.shape[0]
    else:
        n = np.asarray(A).shape[0] if not hasattr(A, "sharding") \
            else A.shape[0]
    m = _mesh_model_size(mesh)
    if n % m != 0:
        raise ValueError(f"distributed solve needs N divisible by the "
                         f"model axis: N={n}, model={m}")
    local = n // m
    block = max(b_ for b_ in (128, 64, 32, 16, 8, 4, 2, 1)
                if local % b_ == 0)
    if staged is None:
        A_dev, b_dev, Are, Aim, bre, bim = stage_operands(mesh, A, b)

    # compute dtype follows the staged operand (backend.default_complex_dtype:
    # c128 on CPU with x64, c64 on the GPU)
    cdtype = A_dev.dtype
    eps_c = float(np.finfo(np.float64 if cdtype == jnp.complex128
                           else np.float32).eps)
    # refinement stops early at tol or on stagnation, so its step budget is
    # generous: with c64 factors each step contracts only by ~κ·ε_f32
    cfg = config or SolverConfig(
        problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
        num_candidates=num_candidates or 16, tol=tol,
        dtype=cdtype, convergence_floor=50 * eps_c,
        refine=True, max_refine_steps=30)
    kn = ProblemKnowledge(shape=(n, n))
    carry, metrics = _mesh_hosted_drive(
        cfg, kn, A_dev, b_dev, jax.random.PRNGKey(seed), max_iterations,
        1, mesh=mesh, dist_block=block, checkpoint_path=checkpoint_path,
        resume_from=resume_from, checkpoint_every=checkpoint_every,
        reopen=reopen, collect_metrics=collect_metrics)
    pop = carry.pop

    @jax.jit
    def _best(v, res):
        i = jnp.argmin(jnp.where(jnp.isfinite(res), res, jnp.inf))
        return v[i]

    x0 = _best(pop.v, pop.residual)
    xre, xim, rel = refine_distributed(
        mesh, carry.fac, Are, Aim, bre, bim, x0, block,
        cfg.max_refine_steps, tol * 0.3,
        sliced=use_dist_sliced(mesh, Are))
    x = np.asarray(xre, np.float64) + 1j * np.asarray(xim, np.float64)
    rel_f = float(rel)
    return SolutionReport(
        problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
        solutions=[(x,)], residuals=[rel_f],
        iterations=int(carry.iteration),
        num_distinct=1 if rel_f <= tol else 0, target_solutions=1,
        landscape_energy=float(carry.strat.landscape_energy),
        knowledge=kn, metrics=_metrics_dict(metrics))


def eig(A, tol: float = 1e-8, max_iterations: int = 200,
        num_candidates: Optional[int] = None, seed: int = 0,
        config: Optional[SolverConfig] = None, mesh=None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        target_solutions: Optional[int] = None,
        knowledge: Optional[ProblemKnowledge] = None) -> SolutionReport:
    """Eigenpairs of A.

    ``knowledge``: optional precomputed :class:`ProblemKnowledge` — skips the
    device diagnosis entirely (constructor parity; the reference's scenario-1
    swap mutates its knowledge dict the same way, AMS:645-652). Use when the
    operand's structure/conditioning is already known — e.g. the 16384²
    probes, which then skip the cond probe's own QR+IR program.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``model`` axis of size > 1
    — the FULL population meta-heuristic (Ψ ladder, α adaptation, strategy
    regimes, retire/respawn — the reference loop, AMS:551-608) then runs with
    A and its Hessenberg form column-sharded over the mesh
    (:func:`maus_tpu.parallel.dist_hessenberg.dist_solve_shifted` carries the
    per-candidate shifted solves), followed by the distributed split-f64
    Newton finisher (:mod:`maus_tpu.parallel.dist_refine`) — eig operands
    larger than one device's memory solve in place with the same engine and
    the same tolerance contract as the single-chip path.
    """
    if mesh is not None and _mesh_model_size(mesh) > 1:
        return _eig_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
                         config, checkpoint_path=checkpoint_path,
                         resume_from=resume_from,
                         checkpoint_every=checkpoint_every)
    s = MausSolver(A, ProblemType.EIGENVALUE,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   target_solutions=target_solutions, knowledge=knowledge)
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


def svd(A, tol: float = 1e-6, max_iterations: int = 300,
        num_candidates: Optional[int] = None, seed: int = 0,
        config: Optional[SolverConfig] = None, mesh=None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        target_solutions: Optional[int] = None,
        knowledge: Optional[ProblemKnowledge] = None) -> SolutionReport:
    """Singular triplets of A.

    ``knowledge``: optional precomputed :class:`ProblemKnowledge` (see
    :func:`eig`).

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``model`` axis of size > 1
    — the FULL population meta-heuristic then runs with A column-sharded (the
    block subspace round distributes under GSPMD with the A shard as the only
    O(M·N) object per device), followed by the factorization-free distributed
    Newton finisher (:mod:`maus_tpu.parallel.dist_refine`) — same engine,
    same tolerance contract as the single-chip path, operands wider than one
    device's memory.
    """
    if mesh is not None and _mesh_model_size(mesh) > 1:
        return _svd_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
                         config, checkpoint_path=checkpoint_path,
                         resume_from=resume_from,
                         checkpoint_every=checkpoint_every)
    s = MausSolver(A, ProblemType.SVD,
                   initial_num_candidates=num_candidates,
                   global_convergence_tol=tol, config=config, seed=seed,
                   target_solutions=target_solutions, knowledge=knowledge)
    return s.evolve(max_iterations, checkpoint_path=checkpoint_path,
                    resume_from=resume_from, checkpoint_every=checkpoint_every)


# ---------------------------------------------------------------------------
# Mesh-sharded eig/SVD: the FULL engine + distributed finishers
# ---------------------------------------------------------------------------

def _mesh_model_size(mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)


def _metrics_dict(metrics):
    """Host-side dict of stacked per-iteration metrics (None passthrough)."""
    if metrics is None:
        return None
    return {f: to_host_complex(getattr(metrics, f)) for f in metrics._fields}


def _reopen_carry(cfg, carry):
    """Reopen a restored carry against a SWAPPED operand (the reference's
    scenario-1 swap continues the same population against the new system,
    AMS:645-652): the saved convergence bookkeeping refers to the OLD
    operand — converged candidates and the carried distinct count would stop
    the loop before a single step against the new one. Converged candidates
    drop to REFINING keeping their iterates as warm starts (with α restored
    to its initial value — frozen slots carry whatever α they converged
    with); residual history and the stop-condition counters reset. The
    factorization/Ψ caches are kept: a stale factorization is just an
    approximate solver, and the Ψ-ladder/refactor machinery recovers from it
    the same way it recovers from any poor factorization."""
    import dataclasses as _dc

    from ..core.types import CandidateStatus

    pop = carry.pop
    conv = pop.status == jnp.int8(CandidateStatus.CONVERGED)
    pop = _dc.replace(
        pop,
        status=jnp.where(conv, jnp.int8(CandidateStatus.REFINING),
                         pop.status),
        alpha=jnp.where(conv, jnp.full_like(pop.alpha, cfg.alpha_initial),
                        pop.alpha),
        residual=jnp.full_like(pop.residual, jnp.inf),
        prev_residual=jnp.full_like(pop.prev_residual, jnp.inf))
    strat = _dc.replace(carry.strat,
                        num_distinct=jnp.zeros_like(carry.strat.num_distinct))
    return carry._replace(
        pop=pop, strat=strat,
        best_residual=jnp.asarray(jnp.inf, carry.best_residual.dtype),
        stall_count=jnp.zeros_like(carry.stall_count))


def _load_resume_carry(cfg, kn, A_dev, key, path, reopen, refactor=None,
                       mesh=None, init_kwargs=None):
    """Shared resume protocol for the single-chip and mesh drivers: restore a
    saved carry from ``path`` against an ABSTRACT template (a concrete
    ``init_carry`` would execute a throwaway O(N³) shared factorization just
    to learn the carry's structure), optionally REOPEN it after an operand
    swap (``_reopen_carry``), and rebuild the now-stale factorization of the
    CURRENT operand at the carried Ψ via ``refactor(psi)``. With ``mesh``,
    the DistQR fac leaves get their column shardings attached to the template
    so ``load_state`` restores them sharded ((N, N/m) per device, not
    replicated)."""
    from ..utils.checkpoint import load_state

    template = jax.eval_shape(
        lambda a, k_: evolve_mod.init_carry(cfg, kn, a, k_,
                                            **(init_kwargs or {})),
        A_dev, key)
    if template.fac is not None and mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import MODEL_AXIS

        col = NamedSharding(mesh, P(None, MODEL_AXIS))
        template = template._replace(fac=jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=col),
            template.fac))
    carry = load_state(path, template)
    if reopen:
        carry = _reopen_carry(cfg, carry)
        if carry.fac is not None and refactor is not None:
            # the carried factorization belongs to the OLD operand; the
            # reference re-solves against the current matrix every step
            # (AMS:645-652 swap), so refactorize the NEW one at the carried Ψ
            carry = carry._replace(fac=refactor(carry.psi_cached))
    return carry


def _mesh_hosted_drive(cfg, kn, A_dev, b_dev, key, max_iterations, target,
                       mesh=None, dist_block: int = 128, hess0=None,
                       checkpoint_path=None, checkpoint_every=None,
                       resume_from=None, reopen: bool = False,
                       collect_metrics: bool = False):
    """Checkpoint/resume-capable driver for the mesh engine paths (the mesh
    counterpart of :meth:`MausSolver.evolve`'s chunked loop, SURVEY §5.4):
    runs the SAME jitted ``evolve_while`` in chunks of ``checkpoint_every``
    iterations with a carry save at every boundary, so a resumed run
    reproduces the uninterrupted one bit-exactly. ``resume_from`` restores
    every carry leaf WITH its mesh sharding (``utils/checkpoint.load_state``
    places leaves by template sharding — the column-sharded DistQR factors
    come back as (N, N/m) shards, not replicated).

    ``mesh`` is forwarded only for paths whose evolve step takes explicit
    mesh routing (linear dist-QR); the SVD mesh engine shards under GSPMD
    with no routing and passes ``mesh=None``. ``max_iterations`` bounds the
    TOTAL iteration count (consistent with a resumed carry's counter).
    """
    kwargs = {}
    if mesh is not None:
        kwargs.update(mesh=mesh, dist_block=dist_block)
    if hess0 is not None:
        kwargs.update(hess0=hess0)

    carry = None
    if resume_from is not None:
        refactor = None
        if mesh is not None:
            from ..ops.regularize import apply_shift
            from ..parallel.dist_qr import dist_qr

            refactor = lambda psi: dist_qr(  # noqa: E731
                mesh, apply_shift(A_dev, psi), block=dist_block)
        carry = _load_resume_carry(
            cfg, kn, A_dev, key, resume_from, reopen, refactor=refactor,
            mesh=mesh,
            init_kwargs=({"mesh": mesh, "dist_block": dist_block}
                         if mesh is not None else {}))

    if checkpoint_every is None:
        if collect_metrics:
            # per-iteration metrics parity with MausSolver.evolve
            # (collect_metrics): fixed-length scan, rows past the stop
            # condition frozen to zeros
            start = 0 if carry is None else int(carry.iteration)
            carry, metrics = evolve_mod.evolve_scan(
                cfg, kn, A_dev, b_dev, key, max(max_iterations - start, 0),
                target, carry0=carry, **kwargs)
        else:
            carry, metrics = evolve_mod.evolve_while(
                cfg, kn, A_dev, b_dev, key, max_iterations, target,
                carry0=carry, **kwargs)
            metrics = None   # while-path metrics are last-iteration only
    else:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        from ..utils.checkpoint import save_state
        every = int(checkpoint_every)
        chunks = []
        while True:
            start = 0 if carry is None else int(carry.iteration)
            bound = min(start + every, max_iterations)
            if collect_metrics:
                carry, m = evolve_mod.evolve_scan(
                    cfg, kn, A_dev, b_dev, key, max(bound - start, 0),
                    target, carry0=carry, **kwargs)
                chunks.append(m)
            else:
                carry, _ = evolve_mod.evolve_while(
                    cfg, kn, A_dev, b_dev, key, bound, target,
                    carry0=carry, **kwargs)
            save_state(checkpoint_path, carry)
            if bound >= max_iterations:
                break
            # mirror the in-loop stop (evolve._stop_condition) EXACTLY — SVD
            # compares against the traced dynamic target alone (AMS:463-470);
            # min()-ing it with the static target here would stop a chunked
            # run at a boundary where the uninterrupted run keeps iterating
            tgt = int(carry.strat.target_dynamic) \
                if cfg.problem_type == ProblemType.SVD else target
            if int(carry.strat.num_distinct) >= tgt or \
                    int(carry.stall_count) >= cfg.stall_limit:
                break
            if int(carry.iteration) <= start:
                # no forward progress and no stop condition: the loop exited
                # for a reason this driver does not resolve (e.g. a
                # host-refactor handoff, which the mesh paths do not use) —
                # break instead of spinning on identical chunks
                break
        if collect_metrics and chunks:
            metrics = chunks[0] if len(chunks) == 1 else \
                jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *chunks)
        else:
            metrics = None
    if checkpoint_path is not None and checkpoint_every is None:
        from ..utils.checkpoint import save_state
        save_state(checkpoint_path, carry)
    return carry, metrics


def _spectral_floor(cdtype, n: int) -> float:
    """Convergence floor (relative to the operand scale — the candidate layer
    multiplies by ‖A‖_F/√N, candidate._adapt_and_classify) for the mesh paths,
    where no host condition estimate exists: √N·ε of the compute dtype with
    the same 50·ε minimum the single-chip constructor uses."""
    eps_c = float(np.finfo(np.float64 if cdtype == jnp.complex128
                           else np.float32).eps)
    return float(min(max(50.0, np.sqrt(n)) * eps_c, 1e-2))


def _eig_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
              config, checkpoint_path=None, resume_from=None,
              checkpoint_every=None, reopen: bool = False,
              staged=None, hess=None,
              collect_metrics: bool = False) -> SolutionReport:
    """eig over a mesh: the FULL MAUS engine (Ψ ladder, α adaptation,
    retire/respawn, strategy regimes — solver/evolve.py) with every shifted
    solve routed through the column-sharded Hessenberg form, then the
    distributed split-f64 Newton finisher (VERDICT r2 #1-2). The bespoke
    plain-iteration driver (parallel/dist_hessenberg.eig_distributed) remains
    as an internal fallback only."""
    from ..parallel.dist_hessenberg import dist_hessenberg
    from ..parallel.dist_refine import dist_refine_eigenpairs, stage_spectral

    if staged is not None:
        A_dev, A64 = staged
        n = A_dev.shape[0]
    else:
        n = np.asarray(A).shape[0] if not hasattr(A, "sharding") \
            else A.shape[0]
    m = _mesh_model_size(mesh)
    if n % m != 0:
        raise ValueError(f"distributed eig needs N divisible by the model "
                         f"axis: N={n}, model={m}")
    k = num_candidates or min(max(8, 2 * int(np.sqrt(n))), 32)
    if staged is None:
        A_dev, A64 = stage_spectral(
            mesh, A, dtype=(config.dtype if config is not None else None))
    cdtype = A_dev.dtype
    cfg = config or SolverConfig(
        problem_type=ProblemType.EIGENVALUE, num_candidates=k, tol=tol,
        dtype=cdtype, convergence_floor=_spectral_floor(cdtype, n))
    kn = ProblemKnowledge(shape=(n, n))
    target = min(n, cfg.num_candidates)

    if hess is None:
        hess = dist_hessenberg(mesh, A_dev)  # built once: engine + finisher
        # (MeshSolver passes a cached one so repeat evolve() calls don't
        # rebuild the O(N³) reduction for an unchanged operand)
    carry, metrics = _mesh_hosted_drive(
        cfg, kn, A_dev, None, jax.random.PRNGKey(seed), max_iterations,
        target, mesh=mesh, hess0=hess, checkpoint_path=checkpoint_path,
        resume_from=resume_from, checkpoint_every=checkpoint_every,
        reopen=reopen, collect_metrics=collect_metrics)

    pop, strat = carry.pop, carry.strat
    diag = strat_mod.compute_diagnostics(cfg, pop, strat, target)
    leader = np.asarray(diag.distinct_leader)
    residual = np.array(pop.residual)
    v = to_host_complex(pop.v)
    lam = to_host_complex(pop.lam)
    order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
    leader_ks = [int(i) for i in order if leader[i]]

    solutions, residuals = [], []
    if leader_ks:
        if cfg.refine:
            # distributed finisher: pad the leader set to the fixed capacity
            # so one compiled shape serves every leader count
            idx = leader_ks + [leader_ks[-1]] * (cfg.num_candidates
                                                 - len(leader_ks))
            lam_j = to_device_complex(lam[idx], cdtype)
            V_j = to_device_complex(v[idx], cdtype)
            lam_s, V_s, res = dist_refine_eigenpairs(mesh, hess, A64, lam_j,
                                                     V_j, steps=5)
            lam_re, lam_im = np.asarray(lam_s.re), np.asarray(lam_s.im)
            v_re, v_im = np.asarray(V_s.re), np.asarray(V_s.im)
            res_h = np.asarray(res)
            for j, slot in enumerate(leader_ks):
                if np.isfinite(res_h[j]) and res_h[j] < residual[slot]:
                    solutions.append(
                        (complex(lam_re[j] + 1j * lam_im[j]),
                         (v_re[j] + 1j * v_im[j]).astype(np.complex128)))
                    residuals.append(float(res_h[j]))
                else:
                    solutions.append((complex(lam[slot]),
                                      v[slot].astype(np.complex128)))
                    residuals.append(float(residual[slot]))
        else:
            for slot in leader_ks:
                solutions.append((complex(lam[slot]),
                                  v[slot].astype(np.complex128)))
                residuals.append(float(residual[slot]))

    solutions, residuals = _final_dedup(cfg, ProblemType.EIGENVALUE,
                                        solutions, residuals)
    return SolutionReport(
        problem_type=ProblemType.EIGENVALUE, solutions=solutions,
        residuals=residuals, iterations=int(carry.iteration),
        num_distinct=len(solutions), target_solutions=target,
        landscape_energy=float(strat.landscape_energy), knowledge=kn,
        metrics=_metrics_dict(metrics))


def _svd_mesh(A, mesh, tol, max_iterations, num_candidates, seed,
              config, checkpoint_path=None, resume_from=None,
              checkpoint_every=None, reopen: bool = False,
              staged=None, collect_metrics: bool = False) -> SolutionReport:
    """SVD over a mesh: the FULL MAUS engine with A column-sharded — the
    block subspace round in candidate.step_svd is plain matmuls + thin QRs,
    which GSPMD distributes with A as the only O(M·N) object — then the
    factorization-free distributed Newton finisher (VERDICT r2 #1-2)."""
    from ..parallel.dist_refine import dist_refine_svd, stage_spectral

    if staged is not None:
        A_dev, A64 = staged
        mr, n = A_dev.shape
    else:
        mr = np.asarray(A).shape[0] if not hasattr(A, "sharding") \
            else A.shape[0]
        n = np.asarray(A).shape[1] if not hasattr(A, "sharding") \
            else A.shape[1]
    m = _mesh_model_size(mesh)
    if n % m != 0:
        raise ValueError(f"distributed svd needs N divisible by the model "
                         f"axis: N={n}, model={m}")
    k = num_candidates or min(max(4, min(mr, n) // 2), 16)
    if staged is None:
        A_dev, A64 = stage_spectral(
            mesh, A, dtype=(config.dtype if config is not None else None))
    cdtype = A_dev.dtype
    cfg = config or SolverConfig(
        problem_type=ProblemType.SVD, num_candidates=k, tol=tol,
        dtype=cdtype, convergence_floor=_spectral_floor(cdtype, max(mr, n)))
    kn = ProblemKnowledge(shape=(mr, n))
    target0 = min(min(mr, n), cfg.num_candidates)

    carry, metrics = _mesh_hosted_drive(
        cfg, kn, A_dev, None, jax.random.PRNGKey(seed), max_iterations,
        target0, checkpoint_path=checkpoint_path, resume_from=resume_from,
        checkpoint_every=checkpoint_every, reopen=reopen,
        collect_metrics=collect_metrics)
    #                                  GSPMD shards the SVD step; no routing
    pop, strat = carry.pop, carry.strat
    # the run's final effective-rank view supersedes the initial target
    # (re-derived on device from the converged σ spectrum, AMS:463-470)
    target = min(int(strat.target_dynamic), target0)
    diag = strat_mod.compute_diagnostics(cfg, pop, strat, target)
    leader = np.asarray(diag.distinct_leader)
    residual = np.array(pop.residual)
    v = to_host_complex(pop.v)
    u = to_host_complex(pop.u)
    sig = to_host_complex(pop.lam).real
    order = np.argsort(np.where(np.isfinite(residual), residual, np.inf))
    leader_ks = [int(i) for i in order if leader[i]]

    solutions, residuals = [], []
    if leader_ks:
        if cfg.refine:
            idx = leader_ks + [leader_ks[-1]] * (cfg.num_candidates
                                                 - len(leader_ks))
            sig_j = to_device_complex(sig[idx].astype(np.complex128), cdtype)
            U_j = to_device_complex(u[idx], cdtype)
            V_j = to_device_complex(v[idx], cdtype)
            sig_s, U_s, V_s, res = dist_refine_svd(mesh, A_dev, A64, sig_j,
                                                   U_j, V_j, steps=5)
            sig_h = np.asarray(sig_s)
            u_re, u_im = np.asarray(U_s.re), np.asarray(U_s.im)
            v_re, v_im = np.asarray(V_s.re), np.asarray(V_s.im)
            res_h = np.asarray(res)
            for j, slot in enumerate(leader_ks):
                if np.isfinite(res_h[j]) and res_h[j] < residual[slot]:
                    solutions.append(
                        (float(sig_h[j]),
                         (u_re[j] + 1j * u_im[j]).astype(np.complex128),
                         (v_re[j] + 1j * v_im[j]).astype(np.complex128)))
                    residuals.append(float(res_h[j]))
                else:
                    solutions.append((float(sig[slot]),
                                      u[slot].astype(np.complex128),
                                      v[slot].astype(np.complex128)))
                    residuals.append(float(residual[slot]))
        else:
            for slot in leader_ks:
                solutions.append((float(sig[slot]),
                                  u[slot].astype(np.complex128),
                                  v[slot].astype(np.complex128)))
                residuals.append(float(residual[slot]))

    solutions, residuals = _final_dedup(cfg, ProblemType.SVD,
                                        solutions, residuals)
    # report the run's effective-rank view in the knowledge (AMS:463-470)
    kn = ProblemKnowledge(shape=(mr, n), effective_rank=target)
    return SolutionReport(
        problem_type=ProblemType.SVD, solutions=solutions,
        residuals=residuals, iterations=int(carry.iteration),
        num_distinct=len(solutions), target_solutions=target,
        landscape_energy=float(strat.landscape_energy), knowledge=kn,
        metrics=_metrics_dict(metrics))


class MeshSolver:
    """Stateful driver for mesh runs — the :class:`MausSolver`-parity surface
    (checkpoint/resume via :meth:`evolve`, mid-run operand swap via
    :meth:`update_problem`, AMS:645-652) for operands column-sharded over a
    device mesh. Wraps the SAME full-engine mesh paths as
    ``solve/eig/svd(mesh=...)``; operands are staged once at construction
    and re-used as device arrays by every subsequent :meth:`evolve` call.

    Like the reference's scenario-1 swap (AMS:645-652), ``update_problem``
    keeps the solver's configuration and re-stages only the changed operands;
    the next :meth:`evolve` run factorizes the new system. Continuing a
    population across the swap is done the same way as on the single-chip
    path: checkpoint the pre-swap run (``checkpoint_path``) and resume the
    post-swap run from it (``resume_from``) — the restored candidates then
    iterate against the NEW operand.
    """

    def __init__(self, matrix, problem_type: ProblemType, mesh,
                 b_vector=None, initial_num_candidates: Optional[int] = None,
                 global_convergence_tol: float = 1e-8,
                 config: Optional[SolverConfig] = None, seed: int = 0):
        self.problem_type = ProblemType(problem_type)
        if mesh is None or _mesh_model_size(mesh) <= 1:
            raise ValueError("MeshSolver needs a mesh with a 'model' axis "
                             "of size > 1 (use MausSolver otherwise)")
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM and \
                b_vector is None:
            raise ValueError("SOLVE_LINEAR_SYSTEM requires b_vector")
        from ..utils.compile_cache import enable_once
        enable_once()
        self.mesh = mesh
        self.tol = float(global_convergence_tol)
        self.num_candidates = initial_num_candidates
        self.config = config
        self.seed = seed
        self._stA = None
        self._stb = None
        self._hess = None        # cached dist_hessenberg of the staged operand
        # operand epoch: bumped by every real swap; checkpoints written by
        # this solver remember the epoch they were taken under, so a resume
        # reopens the carry iff the operand changed SINCE that checkpoint
        # (not merely "a swap happened at some point")
        self._epoch = 0
        self._ckpt_epochs: dict = {}
        self.update_problem(matrix=matrix, b_vector=b_vector)
        self._epoch = 0          # constructor staging is not a swap

    def update_problem(self, matrix=None, b_vector=None) -> None:
        """Swap operands mid-run (scenario-1 parity): each CHANGED operand is
        re-staged from the user's data through the SAME mesh staging as
        construction — compute copy plus ORIGINAL-precision split planes,
        which later refinement certifies against (re-deriving planes from the
        downcast compute copy would certify the c64 rounding instead of the
        user's system). An unchanged operand keeps its staged pieces: no
        re-transfer. A subsequent ``evolve(resume_from=...)`` of a checkpoint
        taken BEFORE the swap automatically REOPENS the restored carry (see
        ``_reopen_carry``) so the population re-evaluates against the new
        system instead of stopping on stale convergence bookkeeping; resuming
        a post-swap checkpoint stays bit-exact (no spurious reopen)."""
        if self.problem_type != ProblemType.SOLVE_LINEAR_SYSTEM and \
                b_vector is not None:
            raise ValueError("b_vector only applies to SOLVE_LINEAR_SYSTEM "
                             "problems")
        changed = False
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            from ..parallel.dist_qr import stage_A, stage_b

            if matrix is not None:
                self._stA = stage_A(self.mesh, matrix)     # (A_dev, Are, Aim)
                changed = True
            if b_vector is not None:
                self._stb = stage_b(self.mesh, b_vector)   # (b_dev, bre, bim)
                changed = True
        elif matrix is not None:
            from ..parallel.dist_refine import stage_spectral

            self._stA = stage_spectral(                    # (A_dev, A64)
                self.mesh, matrix,
                dtype=(self.config.dtype if self.config is not None
                       else None))
            self._hess = None    # the cached reduction is of the old operand
            changed = True
        if changed:
            self._epoch += 1

    def evolve(self, max_iterations: int = 100,
               collect_metrics: bool = False,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None,
               checkpoint_every: Optional[int] = None,
               reopen: Optional[bool] = None) -> SolutionReport:
        """Run the full mesh engine + distributed finishers; same
        checkpoint/resume semantics as :meth:`MausSolver.evolve` (chunks of
        the one jitted loop, bit-exact resume, sharded leaves restored with
        their shardings) and the same ``collect_metrics`` per-iteration
        telemetry (``report.metrics``, SURVEY §5.1/5.5).

        ``reopen=None`` (default) decides automatically from the operand
        epochs: a resumed checkpoint is reopened iff ``update_problem``
        changed an operand since that checkpoint was written (checkpoints
        from other processes, whose epoch is unknown, reopen whenever any
        swap has happened in this solver's lifetime). Pass an explicit bool
        for :meth:`MausSolver.evolve` parity."""
        if reopen is None:
            if resume_from is not None:
                saved = self._ckpt_epochs.get(resume_from)
                reopen = (self._epoch > 0) if saved is None \
                    else (saved != self._epoch)
            else:
                reopen = False
        kw = dict(checkpoint_path=checkpoint_path, resume_from=resume_from,
                  checkpoint_every=checkpoint_every,
                  collect_metrics=collect_metrics, reopen=reopen)
        if self.problem_type == ProblemType.SOLVE_LINEAR_SYSTEM:
            A_dev, Are, Aim = self._stA
            b_dev, bre, bim = self._stb
            rep = _solve_mesh(A_dev, b_dev, self.mesh, self.tol,
                              max_iterations, self.num_candidates,
                              self.seed, self.config,
                              staged=(A_dev, b_dev, Are, Aim, bre, bim),
                              **kw)
        elif self.problem_type == ProblemType.EIGENVALUE:
            if self._hess is None:
                from ..parallel.dist_hessenberg import dist_hessenberg

                # the O(N³) reduction belongs to the staged operand, not to
                # one evolve call — cache it across evolve()s (it is rebuilt
                # only after an update_problem matrix swap)
                self._hess = dist_hessenberg(self.mesh, self._stA[0])
            rep = _eig_mesh(self._stA[0], self.mesh, self.tol,
                            max_iterations, self.num_candidates, self.seed,
                            self.config, staged=self._stA, hess=self._hess,
                            **kw)
        else:
            rep = _svd_mesh(self._stA[0], self.mesh, self.tol,
                            max_iterations, self.num_candidates, self.seed,
                            self.config, staged=self._stA, **kw)
        if checkpoint_path is not None:
            self._ckpt_epochs[checkpoint_path] = self._epoch
        return rep
