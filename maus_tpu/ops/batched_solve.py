"""Batched Ψ-regularized direct solves — the device equivalent of the reference's
``InverseIterateSolver`` direct path (AMS:30-104; LAPACK ``sla.solve`` at AMS:59,
SuperLU ``spla.spsolve`` at AMS:57).

Two entry points, matching how the problem classes actually use the solver:

* :func:`shared_factor_solve` — linear systems. Every candidate solves the *same*
  ``(A + ΨD) x = b`` (the reference re-factorizes per candidate per iteration,
  AMS:224-225 + AMS:59 — K·iters O(N³) LAPACK calls; here ONE factorization is
  computed per Ψ level and *reused across iterations* via the scan carry).

* :func:`batched_shifted_solve` — eigenproblems. Each candidate solves its own
  Rayleigh-shifted system ``(A − λ_k I + Ψ_k D) w = v_k`` (AMS:270-271): genuinely K
  distinct factorizations, vmapped into one batched kernel launch.

Both wrap the Ψ escalation retry ladder (AMS:43-104) as a ``lax.while_loop`` whose
body only re-solves candidates whose previous attempt produced non-finite output —
the batched analogue of the reference's per-candidate ``num_psi_attempts`` loop.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsla

from ..core import backend
from .regularize import apply_shift, psi_magnitude


class LUFactors(NamedTuple):
    """An LU factorization bundle (``jax.scipy.linalg.lu_factor`` layout)."""

    lu: jax.Array
    piv: jax.Array


def factor(H: jax.Array) -> LUFactors:
    """LU-factorize a (possibly batched) square matrix (XLA's LU: LAPACK on
    the CPU, cuSOLVER on the GPU)."""
    if H.ndim == 2:
        lu, piv = jsla.lu_factor(H)
    else:
        lu, piv = jax.vmap(jsla.lu_factor)(H)
    return LUFactors(lu, piv)


def solve_factored(fac: LUFactors, b: jax.Array) -> jax.Array:
    """Triangular solve(s) against an existing factorization."""
    if fac.lu.ndim == 2:
        return jsla.lu_solve((fac.lu, fac.piv), b)
    return jax.vmap(lambda lu, piv, bb: jsla.lu_solve((lu, piv), bb))(fac.lu, fac.piv, b)


def shared_factor(A: jax.Array, psi) -> LUFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once (linear-system path)."""
    return factor(apply_shift(A, psi))


def shared_factor_solve(A: jax.Array, psi_base, aggression, b: jax.Array,
                        max_attempts: int = 4) -> tuple[jax.Array, jax.Array]:
    """Solve ``(A + ΨD) x = b`` with the Ψ escalation ladder (AMS:43-104).

    Returns ``(x, attempts_used)``. Escalation triggers on non-finite output —
    the reference's failure signal (AMS:94-95).
    """
    def attempt_solve(attempt):
        psi = psi_magnitude(psi_base, aggression, attempt, 0.0)
        return solve_factored(shared_factor(A, psi), b)

    def cond(carry):
        attempt, x = carry
        return (attempt < max_attempts) & ~jnp.all(jnp.isfinite(
            jnp.concatenate([x.real.ravel(), x.imag.ravel()])
            if jnp.iscomplexobj(x) else x.ravel()))

    def body(carry):
        attempt, _ = carry
        return attempt + 1, attempt_solve(attempt + 1)

    x0 = attempt_solve(0)
    attempts, x = jax.lax.while_loop(cond, body, (jnp.asarray(0, jnp.int32), x0))
    return x, attempts


def _finite_rows(x: jax.Array) -> jax.Array:
    """Per-row finiteness mask for a (K, N) batch."""
    if jnp.iscomplexobj(x):
        ok = jnp.isfinite(x.real) & jnp.isfinite(x.imag)
    else:
        ok = jnp.isfinite(x)
    return jnp.all(ok, axis=-1)


def psi_ladder(solve_at, K: int, max_attempts: int
               ) -> tuple[jax.Array, jax.Array]:
    """Generic batched Ψ escalation ladder (AMS:43-104 semantics).

    ``solve_at(attempt_k: (K,) int32) -> (K, N)`` performs the solve at the
    given per-candidate attempt levels. Candidates whose result is finite are
    frozen; the loop re-solves only while some candidate is non-finite and
    attempts remain. Returns ``(W, attempts)``.
    """
    W0 = solve_at(jnp.zeros((K,), jnp.int32))
    ok0 = _finite_rows(W0)
    attempts0 = jnp.zeros((K,), jnp.int32)

    def cond(carry):
        attempts, W, ok = carry
        return jnp.any(~ok & (attempts < max_attempts))

    def body(carry):
        attempts, W, ok = carry
        attempts_new = jnp.where(ok, attempts, attempts + 1)
        W_try = solve_at(attempts_new)
        ok_try = _finite_rows(W_try)
        W_out = jnp.where(ok[:, None], W, W_try)
        return attempts_new, W_out, ok | ok_try

    attempts, W, ok = jax.lax.while_loop(cond, body, (attempts0, W0, ok0))
    # still non-finite after the ladder: zero them; the candidate layer treats
    # a zero update as a solve failure (stuck++/weight collapse, AMS:287-293)
    W = jnp.where(ok[:, None], W, jnp.zeros_like(W))
    return W, attempts


def batched_shifted_solve(A: jax.Array, lams: jax.Array, stuck: jax.Array,
                          psi_base, aggression, B: jax.Array,
                          max_attempts: int = 4) -> tuple[jax.Array, jax.Array]:
    """Solve ``(A − λ_k I + Ψ_k D) w_k = B_k`` for a batch of K candidates.

    ``Ψ_k`` follows the reference schedule — it grows with the candidate's stuck
    counter and with the retry attempt (AMS:44). Candidates whose solve produced a
    finite vector are frozen; the while_loop only continues while some candidate is
    non-finite and attempts remain.

    Returns ``(W, attempts)`` with ``W: (K, N)`` and ``attempts: (K,) int32`` — the
    per-candidate Ψ-attempt count (a diagnostics signal the strategy layer consumes,
    mirroring ``num_psi_attempts``, AMS:39-104).
    """
    K, N = B.shape

    def solve_at(attempt_k):
        """attempt_k: (K,) attempt level per candidate."""
        psi = psi_magnitude(psi_base, aggression, attempt_k, stuck)

        def one(lam_k, psi_k, b_k):
            shift = -lam_k * jnp.ones((N,), A.dtype)
            H = apply_shift(A, psi_k, extra_diag=shift)
            lu, piv = jsla.lu_factor(H)
            return jsla.lu_solve((lu, piv), b_k)

        return jax.vmap(one)(lams, psi, B)

    return psi_ladder(solve_at, K, max_attempts)


# ---------------------------------------------------------------------------
# Hermitian-positive-definite path: Cholesky (SURVEY §7.1 cholesky_batched)
# ---------------------------------------------------------------------------

class CholFactors(NamedTuple):
    """A Cholesky factorization bundle, duck-compatible with LUFactors for
    :func:`solve_factored`-style use via :func:`solve_chol`."""

    L: jax.Array


def factor_chol(H: jax.Array) -> CholFactors:
    """Cholesky of an HPD (possibly batched) matrix — half the flops of LU; the Ψ shift keeps H safely positive definite."""
    if H.ndim == 2:
        L = jnp.linalg.cholesky(H)
    else:
        L = jax.vmap(jnp.linalg.cholesky)(H)
    return CholFactors(L)


def solve_chol(fac: CholFactors, b: jax.Array) -> jax.Array:
    """Two triangular solves against the Cholesky factor."""
    def one(L, bb):
        y = jsla.solve_triangular(L, bb, lower=True)
        return jsla.solve_triangular(jnp.conj(L.T), y, lower=False)
    if fac.L.ndim == 2:
        return one(fac.L, b)
    return jax.vmap(one)(fac.L, b)


def shared_factor_hpd(A: jax.Array, psi) -> CholFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once via Cholesky (HPD linear path)."""
    return factor_chol(apply_shift(A, psi))


# ---------------------------------------------------------------------------
# QR path for the shared linear factorization
# ---------------------------------------------------------------------------

class QRFactors(NamedTuple):
    """Householder-QR factorization bundle.

    The shared linear factorization defaults to QR: its solve path is one
    triangular substitution instead of LU's two, and its backward error
    keeps the mixed-precision refinement to a few steps. LU remains for the
    batched per-candidate eigen shifts. Whether LU (half QR's flops) is the
    better choice on the GPU is open (ROADMAP S4).

    ``rinv``: optional explicit R⁻¹, built once by GEMM-rich blocked
    inversion (:func:`invert_triangular`), so that every subsequent solve is
    two GEMVs instead of a triangular substitution. Forward
    error of applying an explicit triangular inverse is O(ε·κ) — the same
    order as the forward error of a backward-stable substitution — and in
    iterative refinement the correction solve is a preconditioner, so the
    contraction rate is unchanged (standard practice in mixed-precision IR
    solvers).
    """

    q: jax.Array
    r: jax.Array
    rinv: jax.Array | None = None


def invert_triangular(R: jax.Array, block: int = 128) -> jax.Array:
    """Explicit inverse of an upper-triangular R via blocked recursion:

        [R₁₁ R₁₂]⁻¹   [R₁₁⁻¹   −R₁₁⁻¹ R₁₂ R₂₂⁻¹]
        [ 0  R₂₂]   = [ 0            R₂₂⁻¹     ]

    All off-diagonal work is GEMMs; only ``block``-sized diagonal
    tiles hit the slow triangular-solve primitive. One-time O(N³/3) — the
    point is to amortize it over many solve calls (evolve iterations,
    refinement steps, GMRES-IR matvecs)."""
    hi = jax.lax.Precision.HIGHEST
    n = R.shape[0]
    if n <= block:
        return jsla.solve_triangular(R, jnp.eye(n, dtype=R.dtype),
                                     lower=False)
    h = ((n // 2 + block - 1) // block) * block
    h = min(h, n - 1)
    X11 = invert_triangular(R[:h, :h], block)
    X22 = invert_triangular(R[h:, h:], block)
    X12 = -jnp.matmul(X11, jnp.matmul(R[:h, h:], X22, precision=hi),
                      precision=hi)
    top = jnp.concatenate([X11, X12], axis=1)
    bot = jnp.concatenate([jnp.zeros((n - h, h), R.dtype), X22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


# The refinement's N²-sized working set, counted in buffers of the working
# dtype (f64 planes, Q, R, R⁻¹ and workspace). R⁻¹ is built only while this
# many fit device memory: on the 15.75 GB device the rule was first sized on
# that admits N = 8192 and not 16384.
_RINV_WORKSET_BUFFERS = 16


def _want_rinv(H: jax.Array) -> bool:
    """Policy for building the explicit R⁻¹ with the shared factorization:
    single operand, on an accelerator (the CPU's triangular solves are
    already at bandwidth), N ≥ 1024 so the triangular-solve overhead
    dominates (the inversion is ~one QR panel's worth of GEMMs), and small
    enough that the extra N² buffer fits next to the refinement's working
    set. The 1024 floor and the accelerator rule were chosen before the GPU
    port and are not measured on the H100 (ROADMAP S7)."""
    if H.ndim != 2 or H.shape[0] < 1024 or not backend.is_accelerator():
        return False
    n = H.shape[0]
    need = _RINV_WORKSET_BUFFERS * n * n * jnp.dtype(H.dtype).itemsize
    return need <= backend.device_memory_bytes()


def factor_qr(H: jax.Array, with_rinv: bool | None = None) -> QRFactors:
    if H.ndim == 2:
        q, r = jnp.linalg.qr(H)
        if with_rinv is None:
            with_rinv = _want_rinv(H)
        rinv = invert_triangular(r) if with_rinv else None
        return QRFactors(q, r, rinv)
    q, r = jax.vmap(jnp.linalg.qr)(H)
    return QRFactors(q, r, None)


def solve_qr(fac: QRFactors, b: jax.Array) -> jax.Array:
    """x = R⁻¹ Qᴴ b — two GEMVs when the explicit R⁻¹ is present, one GEMV +
    a triangular substitution otherwise."""
    hi = jax.lax.Precision.HIGHEST

    def one(q, r, bb):
        y = jnp.matmul(jnp.conj(q.T), bb, precision=hi)
        if fac.rinv is not None:
            return jnp.matmul(fac.rinv, y, precision=hi)
        return jsla.solve_triangular(r, y, lower=False)

    if fac.q.ndim == 2:
        return one(fac.q, fac.r, b)
    return jax.vmap(one)(fac.q, fac.r, b)


def shared_factor_qr(A: jax.Array, psi,
                     with_rinv: bool | None = None) -> QRFactors:
    """Factor ``H = A + Ψ·(I + jitter)`` once via QR (default linear path)."""
    return factor_qr(apply_shift(A, psi), with_rinv=with_rinv)
