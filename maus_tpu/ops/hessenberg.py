"""Hessenberg reduction + batched shifted Hessenberg solves.

THE structural optimization of the eigen hot path (VERDICT r1 #1). The
reference solves ``(A − λ_k I + ΨD) w = v_k`` with one LAPACK LU per candidate
per iteration (AMS:224-225/270-271) — O(K·N³) per iteration, and small-n
batched pivoting maps poorly onto matrix units.

Restructure: all K shifted operators share A, so reduce
``A = Q H Qᴴ`` (upper Hessenberg) ONCE — O(N³), paid at setup — after which

    (A − λI)⁻¹ v  =  Q · (H − λI)⁻¹ · Qᴴ v

and each shifted solve is a **Givens QR of an upper-Hessenberg matrix**:
O(N²) per candidate with no pivoting (Givens is unconditionally stable), all
batched over K as (K, N) row operations. Per iteration the eig path now costs
two (K,N)×(N,N) GEMMs (memory-bound) + one O(K·N²) banded sweep instead
of K LU factorizations.

``jax.lax.linalg.hessenberg`` lowers on the CPU only (JAX 0.9), so the
reduction is implemented here: N−2 masked Householder similarity steps under
``lax.scan``, or their blocked compact-WY form — fixed shapes, O(N³) total,
one-time.

Context in the multi-shift solver literature (PAPERS.md): shifted-system
Krylov methods (multiple-mass solvers, multipreconditioned GMRES for shifted
systems) share one Krylov space across shifts but require a COMMON rhs; the
population's systems have per-candidate rhs v_k, which is exactly the case the
shared-Hessenberg factorization handles — one O(N³) reduction amortized over
arbitrary (shift, rhs) pairs at O(N²) each.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import backend


class HessCache(NamedTuple):
    """Shared Hessenberg form of the operand: A = Q H Qᴴ."""

    h: jax.Array    # (N, N) upper Hessenberg
    q: jax.Array    # (N, N) unitary


@functools.partial(jax.jit)
def reduce_hessenberg(A: jax.Array) -> HessCache:
    """Householder reduction to upper Hessenberg form (one-time O(N³))."""
    N = A.shape[0]
    dtype = A.dtype
    rdt = jnp.finfo(dtype).dtype
    rows = jnp.arange(N)

    with jax.default_matmul_precision("highest"):
        def step(carry, j):
            H, Q = carry
            col = jax.lax.dynamic_slice_in_dim(H, j, 1, axis=1)[:, 0]  # (N,)
            tail = rows > j                  # support of the Householder vector
            x = jnp.where(tail, col, 0.0)
            normx = jnp.linalg.norm(x)
            pivot = jnp.sum(jnp.where(rows == j + 1, x, 0.0))
            # complex sign(pivot); 1 for zero pivot
            absp = jnp.abs(pivot)
            sign = jnp.where(absp > 0, pivot / jnp.maximum(absp, 1e-30),
                             jnp.ones_like(pivot))
            beta = -sign * normx.astype(dtype)
            v = x - beta * (rows == j + 1).astype(dtype)
            vn = jnp.linalg.norm(v)
            ok = (vn.real > jnp.asarray(1e-30, rdt)) & \
                 (normx.real > jnp.asarray(1e-30, rdt))
            v = jnp.where(ok, v / jnp.maximum(vn, jnp.asarray(1e-30, rdt)
                                              .astype(vn.dtype)), 0.0)
            # similarity update H ← P H P, accumulate Q ← Q P  (P = I − 2vvᴴ)
            w = jnp.conj(v) @ H                       # (N,)
            H = H - 2.0 * jnp.outer(v, w)
            u = H @ v
            H = H - 2.0 * jnp.outer(u, jnp.conj(v))
            qv = Q @ v
            Q = Q - 2.0 * jnp.outer(qv, jnp.conj(v))
            return (H, Q), None

        Q0 = jnp.eye(N, dtype=dtype)
        (H, Q), _ = jax.lax.scan(step, (A, Q0), jnp.arange(max(N - 2, 0)))
        # clean sub-subdiagonal rounding dust so downstream code may rely on
        # exact Hessenberg structure
        r = rows[:, None]
        c = rows[None, :]
        H = jnp.where(r > c + 1, 0.0, H)
        return HessCache(h=H, q=Q)


@functools.partial(jax.jit, static_argnames=("nb",))
def reduce_hessenberg_blocked(A: jax.Array, nb: int = 64) -> HessCache:
    """Blocked (compact-WY) Householder reduction to upper Hessenberg.

    Same mathematical factorization as :func:`reduce_hessenberg` but the
    similarity updates are applied per PANEL of ``nb`` reflectors through the
    compact representation ``P = I − V T Vᴴ``:

    * within a panel, the current column of the partially-reduced matrix is
      reconstructed from (V, T, Y = H·V) with thin O(N·nb) operations plus
      ONE full GEMV per reflector (the Y append — the algorithm's memory
      floor);
    * at panel end the whole matrix and Q take three N×nb×N GEMM updates
      (``H ← Pᴴ(H − Y·T·Vᴴ)``, ``Q ← Q − (QV)·T·Vᴴ``) instead of
      6·nb rank-1/GEMV passes.

    The scan version pays ~6 N² passes plus a launch per column. Any N is
    supported: full panels run under the scan and the (N−2) mod nb remainder
    finishes with single-column steps. Callers should use
    :func:`reduce_hessenberg_auto`, which also falls back to the scan
    version for small N.
    """
    N = A.shape[0]
    dtype = A.dtype
    rdt = jnp.finfo(dtype).dtype
    rows = jnp.arange(N)
    n_panels = (N - 2) // nb            # remainder handled by single steps
    tau = jnp.asarray(2.0, dtype)

    with jax.default_matmul_precision("highest"):
        def reflector(col, c):
            """Householder v (normalized, support rows > c) zeroing col below
            row c+1 — identical construction to reduce_hessenberg's step."""
            tail = rows > c
            x = jnp.where(tail, col, 0.0)
            normx = jnp.linalg.norm(x)
            pivot = jnp.sum(jnp.where(rows == c + 1, x, 0.0))
            absp = jnp.abs(pivot)
            sign = jnp.where(absp > 0, pivot / jnp.maximum(absp, 1e-30),
                             jnp.ones_like(pivot))
            beta = -sign * normx.astype(dtype)
            v = x - beta * (rows == c + 1).astype(dtype)
            vn = jnp.linalg.norm(v)
            ok = (vn.real > jnp.asarray(1e-30, rdt)) & \
                 (normx.real > jnp.asarray(1e-30, rdt))
            return jnp.where(
                ok, v / jnp.maximum(vn, jnp.asarray(1e-30, rdt)
                                    .astype(vn.dtype)), 0.0)

        def panel(carry, p):
            H, Q = carry
            s = p * nb                     # panel covers columns s .. s+nb−1

            def inner(j, st):
                V, T, Y = st
                c = s + j
                # current column c of Pᴴ H P from the compact representation
                a_c = jax.lax.dynamic_slice(H, (0, c), (N, 1))[:, 0]
                vrow = jnp.conj(jax.lax.dynamic_slice(V, (c, 0),
                                                      (1, nb))[0])    # Vᴴe_c
                g = a_c - Y @ (T @ vrow)
                col = g - V @ (jnp.conj(T).T @ (jnp.conj(V).T @ g))
                v = reflector(col, c)
                # T ← [[T, −T (Vᴴ v) τ], [0, τ]]  (column j)
                tcol = -(T @ (jnp.conj(V).T @ v)) * tau
                T_new = T.at[:, j].set(tcol).at[j, j].set(tau)
                V_new = V.at[:, j].set(v)
                Y_new = Y.at[:, j].set(H @ v)
                return V_new, T_new, Y_new

            V0 = jnp.zeros((N, nb), dtype)
            T0 = jnp.zeros((nb, nb), dtype)
            Y0 = jnp.zeros((N, nb), dtype)
            V, T, Y = jax.lax.fori_loop(0, nb, inner, (V0, T0, Y0))
            # block similarity update: HP = H − Y T Vᴴ; H ← HP − V Tᴴ Vᴴ HP
            W = T @ jnp.conj(V).T                       # (nb, N)
            HP = H - Y @ W
            H = HP - V @ (jnp.conj(T).T @ (jnp.conj(V).T @ HP))
            Q = Q - (Q @ V) @ W
            return (H, Q), None

        Q0 = jnp.eye(N, dtype=dtype)
        (H, Q), _ = jax.lax.scan(panel, (A, Q0), jnp.arange(n_panels))

        # remainder reflectors (< nb of them): plain per-column similarity
        def tail_step(carry, c):
            H, Q = carry
            col = jax.lax.dynamic_slice(H, (0, c), (N, 1))[:, 0]
            v = reflector(col, c)
            w = jnp.conj(v) @ H
            H = H - 2.0 * jnp.outer(v, w)
            u = H @ v
            H = H - 2.0 * jnp.outer(u, jnp.conj(v))
            qv = Q @ v
            Q = Q - 2.0 * jnp.outer(qv, jnp.conj(v))
            return (H, Q), None

        if n_panels * nb < N - 2:
            (H, Q), _ = jax.lax.scan(tail_step, (H, Q),
                                     jnp.arange(n_panels * nb, N - 2))
        r = rows[:, None]
        c = rows[None, :]
        H = jnp.where(r > c + 1, 0.0, H)
        return HessCache(h=H, q=Q)


def reduce_hessenberg_auto(A: jax.Array, nb: int = 64) -> HessCache:
    """Blocked reduction when N is large enough to amortize panels; plain
    scan version otherwise."""
    if A.shape[0] - 2 >= 2 * nb:
        return reduce_hessenberg_blocked(A, nb=nb)
    return reduce_hessenberg(A)


# The scan-based sweep materializes the evolving (K, N, N) triangularization
# as a double-buffered loop carry — 2·K·N²·itemsize bytes of temps (34 GiB at
# N=8192, K=32 in c64). Past a share of device memory the sweep runs
# candidate-chunked under lax.map: identical flops, K/KC× the scan-launch
# latency, temps bounded by the chunk budget. The shares are 9 GiB and 4 GiB
# of the 15.75 GB device the rule was first sized on.
_HESS_SOLVE_TEMP_SHARE = 0.61      # single batch allowed up to this share
_HESS_SOLVE_CHUNK_SHARE = 0.27     # per-chunk temp share once chunked


def _hess_solve_budgets() -> tuple[int, int]:
    """(single-batch temp cap, per-chunk temp budget) in bytes."""
    mem = backend.device_memory_bytes()
    return int(_HESS_SOLVE_TEMP_SHARE * mem), int(_HESS_SOLVE_CHUNK_SHARE * mem)


@functools.partial(jax.jit)
def solve_shifted_hessenberg(H: jax.Array, lams: jax.Array, B: jax.Array,
                             psi: jax.Array | None = None) -> jax.Array:
    """Solve ``(H − λ_k I + ψ_k I) w_k = b_k`` for K candidates at once.

    Givens QR sweep down the subdiagonal (scan over columns, each step a
    batched (K,·) row rotation) followed by back substitution — O(K·N²) total,
    no pivoting needed. ``psi``: optional (K,) real regularization added to
    the shifted diagonal (the Ψ ladder's rung, reference AMS:44).

    Large (K, N) batches run candidate-chunked (see _hess_solve_budgets).
    """
    K, N = B.shape
    percand = 2 * N * N * jnp.dtype(B.dtype).itemsize
    temp_cap, chunk_budget = _hess_solve_budgets()
    if K * percand > temp_cap:
        kc = max(1, int(chunk_budget // percand))
        g = -(-K // kc)
        pad = g * kc - K
        lams_p = jnp.concatenate([lams, jnp.broadcast_to(lams[-1:], (pad,))])
        B_p = jnp.concatenate([B, jnp.broadcast_to(B[-1:], (pad, N))])
        if psi is not None:
            psi_p = jnp.concatenate([psi,
                                     jnp.broadcast_to(psi[-1:], (pad,))])
            out = jax.lax.map(
                lambda t: _hess_solve_scan(H, t[0], t[1], t[2]),
                (lams_p.reshape(g, kc), B_p.reshape(g, kc, N),
                 psi_p.reshape(g, kc)))
        else:
            out = jax.lax.map(
                lambda t: _hess_solve_scan(H, t[0], t[1], None),
                (lams_p.reshape(g, kc), B_p.reshape(g, kc, N)))
        return out.reshape(g * kc, N)[:K]
    return _hess_solve_scan(H, lams, B, psi)


def _hess_solve_scan(H: jax.Array, lams: jax.Array, B: jax.Array,
                     psi: jax.Array | None = None) -> jax.Array:
    K, N = B.shape
    dtype = B.dtype
    rdt = jnp.finfo(dtype).dtype
    cols = jnp.arange(N)

    with jax.default_matmul_precision("highest"):
        shift = -lams
        if psi is not None:
            shift = shift + psi.astype(dtype)
        # R0: (K, N, N) shifted Hessenberg per candidate
        R = jnp.broadcast_to(H[None], (K, N, N)) + \
            shift[:, None, None] * jnp.eye(N, dtype=dtype)[None]
        y = B

        def fwd(carry, j):
            R, y = carry
            rj = jax.lax.dynamic_slice_in_dim(R, j, 2, axis=1)    # (K, 2, N)
            a = jnp.sum(jnp.where(cols[None, :] == j, rj[:, 0], 0.0), axis=-1)
            b = jnp.sum(jnp.where(cols[None, :] == j, rj[:, 1], 0.0), axis=-1)
            # complex Givens: r = √(|a|²+|b|²), c = |a|/r, s = sign(a)·conj(b)/r
            r2 = (jnp.abs(a) ** 2 + jnp.abs(b) ** 2).real
            r = jnp.sqrt(jnp.maximum(r2, jnp.asarray(1e-30, rdt)))
            nontrivial = jnp.abs(b) > 0
            absa = jnp.abs(a)
            signa = jnp.where(absa > 0, a / jnp.maximum(absa, 1e-30),
                              jnp.ones_like(a))
            c = (absa / r).astype(dtype)
            s = signa * jnp.conj(b) / r.astype(dtype)
            c = jnp.where(nontrivial, c, jnp.ones_like(c))
            s = jnp.where(nontrivial, s, jnp.zeros_like(s))
            row0 = c[:, None] * rj[:, 0] + s[:, None] * rj[:, 1]
            row1 = -jnp.conj(s)[:, None] * rj[:, 0] + \
                jnp.conj(c)[:, None] * rj[:, 1]
            R = jax.lax.dynamic_update_slice_in_dim(
                R, jnp.stack([row0, row1], axis=1), j, axis=1)
            yj = jax.lax.dynamic_slice_in_dim(y, j, 2, axis=1)     # (K, 2)
            y0 = c * yj[:, 0] + s * yj[:, 1]
            y1 = -jnp.conj(s) * yj[:, 0] + jnp.conj(c) * yj[:, 1]
            y = jax.lax.dynamic_update_slice_in_dim(
                y, jnp.stack([y0, y1], axis=1), j, axis=1)
            return (R, y), None

        (R, y), _ = jax.lax.scan(fwd, (R, y), jnp.arange(max(N - 1, 0)))

        def bwd(x, j):
            Rj = jax.lax.dynamic_slice_in_dim(R, j, 1, axis=1)[:, 0]  # (K, N)
            rjj = jnp.sum(jnp.where(cols[None, :] == j, Rj, 0.0), axis=-1)
            dot = jnp.sum(jnp.where(cols[None, :] > j, Rj * x, 0.0), axis=-1)
            yj = jnp.sum(jnp.where(cols[None, :] == j, y, 0.0), axis=-1)
            safe = jnp.abs(rjj) > 0
            xj = jnp.where(safe, (yj - dot) / jnp.where(safe, rjj, 1.0),
                           jnp.asarray(jnp.inf, dtype))
            x = x + xj[:, None] * (cols[None, :] == j).astype(dtype)
            return x, None

        x0 = jnp.zeros_like(B)
        x, _ = jax.lax.scan(bwd, x0, jnp.arange(N - 1, -1, -1))
        return x


def solve_shifted_via_hessenberg(cache: HessCache, lams: jax.Array,
                                 B: jax.Array,
                                 psi: jax.Array | None = None) -> jax.Array:
    """(A − λ_k I + ψ_k I)⁻¹ b_k given the shared Hessenberg form of A."""
    with jax.default_matmul_precision("highest"):
        Bh = B @ jnp.conj(cache.q)              # rows = Qᴴ b_k
        W = solve_shifted_hessenberg(cache.h, lams, Bh, psi)
        return W @ cache.q.T                    # rows = Q w_k
