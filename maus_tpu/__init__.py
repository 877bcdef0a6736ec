"""maus_tpu — a JAX rebuild of Kier73/Adaptive-Matrix-Solver (MAUS) for
accelerators (NVIDIA GPUs) and the CPU.

A population-based meta-heuristic engine solving linear systems Ax=b, eigenvalue
problems Ax=λx, and SVD: the candidate population is one batched SoA pytree,
Ψ-regularized shifted solves run as batched device operations, and the whole
evolution loop is jitted ``lax`` control flow. See SURVEY.md at the repo root
for the reference analysis this build follows.
"""
import sys as _sys

# JAX tracing is recursive; the evolve loop's nesting (jit → while_loop →
# cond → Ψ-ladder while_loop → fori_loop, with the finishers inside) can
# exceed CPython's default 1000-frame limit while the full program traces.
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 10_000))

from .core.types import (CandidateStatus, ProblemKnowledge, ProblemType,
                         SolverConfig, SolverPreference, StabilityState)
from .parallel.dist_hessenberg import eig_distributed
from .parallel.dist_qr import solve_distributed
from .solver.api import (MausSolver, MeshSolver, SolutionReport, eig, solve,
                         svd)

__version__ = "0.2.0"

__all__ = [
    "CandidateStatus", "MausSolver", "MeshSolver", "ProblemKnowledge",
    "ProblemType", "SolutionReport", "SolverConfig", "SolverPreference",
    "StabilityState", "eig", "eig_distributed", "solve", "solve_distributed",
    "svd", "__version__",
]
