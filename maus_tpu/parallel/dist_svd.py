"""Distributed (column-sharded) SVD: block subspace iteration over a mesh.

Completes the distributed story for the third problem class (linear → dist_qr,
eig → dist_hessenberg, SVD → here). The single-chip SVD hot path
(``solver/candidate.step_svd``, block mode) runs one round of subspace
iteration with a Rayleigh–Ritz rotation per population step; this module runs
the same block round with **A column-sharded over the mesh's model axis** so
an operand wider than one chip's HBM iterates in place:

* ``Y = A Vᴴ`` — local ``A_loc @ V_locᴴ`` partial products, one ``psum``
  (Y is M×k, small: k candidates ≪ N);
* thin QR of Y — replicated (O(M·k²), k small);
* ``Z = Quᴴ A`` — purely column-local;
* thin QR of the tall sharded ``Zᴴ`` (N×k) — **CholeskyQR2**: two k×k Gram
  ``psum``s + local triangular solves, O(N·k²/m) flops per device and O(k²)
  bytes on the wire (vs O(N·k) for a gathered QR);
* k×k Ritz SVD — replicated.

Per-iteration communication: one (M, k) psum + two (k, k) psums. The Ritz
values converge at (σ_{k+1}/σ_i) per round (same argument as the single-chip
block mode's docstring).

Reference parity: distributes the reference's alternating one-sided power
iteration u = Av/σ, v = Aᴴu/‖·‖ (AMS:227-255) at population scale; the
reference itself has no distributed capability (SURVEY.md §2.3). Residuals
are the reference's two-sided ‖Av − σu‖ + ‖Aᴴu − σv‖ (M4g, AMS:301), measured
against the sharded original A.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import MODEL_AXIS


def _axis_me():
    return jax.lax.axis_index(MODEL_AXIS)


@partial(jax.jit, static_argnames=("mesh", "k", "iterations"))
def _svd_iterate(mesh: Mesh, A: jax.Array, key: jax.Array, k: int,
                 iterations: int):
    """Block subspace iteration on column-sharded A; returns replicated
    (sigma (k,), U (M,k), V (k,N), resid (k,)) — Ritz triplets sorted as
    produced (descending σ), residuals two-sided vs A."""
    mrows, n = A.shape
    m = mesh.shape[MODEL_AXIS]
    c = n // m
    dtype = A.dtype
    rdt = jnp.finfo(dtype).dtype
    hi = jax.lax.Precision.HIGHEST

    kr, ki = jax.random.split(key)
    V0 = jax.lax.complex(jax.random.normal(kr, (k, n), rdt),
                         jax.random.normal(ki, (k, n), rdt)).astype(dtype)
    V0 = V0 / jnp.linalg.norm(V0, axis=-1, keepdims=True)

    def local(a_loc, v0):
        me = _axis_me()

        def vslice(v):
            """Local-column slice of a replicated (k, N) array → (k, C)."""
            return jax.lax.dynamic_slice(v, (me * 0, me * c), (k, c))

        def chol_qr(t_loc, jitter):
            """One CholeskyQR pass on the tall sharded T (N, k), local block
            (C, k). Returns (Q_loc, R upper (k, k) replicated)."""
            G = jax.lax.psum(
                jnp.matmul(jnp.conj(t_loc).T, t_loc, precision=hi),
                MODEL_AXIS)
            tr = jnp.trace(G).real
            G = G + (jitter * jnp.maximum(tr, 1.0) / k) * jnp.eye(k, dtype=dtype)
            L = jnp.linalg.cholesky(G)
            R = jnp.conj(L).T                          # upper: G = Rᴴ R
            q_loc = jax.scipy.linalg.solve_triangular(
                L, jnp.conj(t_loc).T, lower=True)      # (k, C) = R⁻ᴴ Tᴴ
            return jnp.conj(q_loc).T, R                # (C, k), (k, k)

        def two_sided_resid(v_loc, U, sigma):
            """(k,) two-sided residual (M4g): ‖Av − σu‖ + ‖Aᴴu − σv‖."""
            Av = jax.lax.psum(
                jnp.matmul(a_loc, v_loc.T, precision=hi).T,
                MODEL_AXIS)                            # (k, M): rows = (A v_k)ᵀ
            r1 = jnp.linalg.norm(Av - sigma[:, None] * U.T, axis=-1).real
            Ahu_loc = jnp.matmul(jnp.conj(a_loc).T, U,
                                 precision=hi).T       # (k, C)
            r2sq = jax.lax.psum(
                jnp.sum(jnp.abs(Ahu_loc - sigma[:, None] * v_loc) ** 2,
                        axis=-1),
                MODEL_AXIS).real
            return r1 + jnp.sqrt(r2sq)

        def round_once(v_loc):
            # Y = A Vᵀ : (M, k), one psum (V rows are the candidates;
            # matches step_svd's Y = (V @ A.T).T)
            Y = jax.lax.psum(
                jnp.matmul(a_loc, v_loc.T, precision=hi),
                MODEL_AXIS)
            Qu, _ = jnp.linalg.qr(Y)                   # (M, k) replicated
            # Z = Quᴴ A : column-local (k, C)
            z_loc = jnp.matmul(jnp.conj(Qu).T, a_loc, precision=hi)
            # CholeskyQR2 of Zᴴ (N, k) → Qv sharded + R upper
            eps2 = jnp.asarray(jnp.finfo(rdt).eps, rdt) ** 2
            q1, r1 = chol_qr(jnp.conj(z_loc).T, eps2 * 100.0)
            q2, r2 = chol_qr(q1, jnp.zeros((), rdt))
            Rz = jnp.matmul(r2, r1, precision=hi)      # (k, k) upper
            # Ritz rotation: svd of Rzᴴ (matches step_svd's conj(Rz).T)
            Us, S, Vsh = jnp.linalg.svd(jnp.conj(Rz).T)
            U = jnp.matmul(Qu, Us, precision=hi)       # (M, k)
            v_new_loc = jnp.matmul(q2, jnp.conj(Vsh).T,
                                   precision=hi).T     # (k, C)
            return v_new_loc, U, S.astype(rdt)

        # ``iterations`` is an upper BOUND (the caller's max_iterations,
        # honored verbatim — no silent clamp): each round costs three psums,
        # so iterating past convergence wastes collective time. Patience-based
        # early exit, mirroring _eig_iterate (parallel/dist_hessenberg.py).
        eps = jnp.asarray(jnp.finfo(rdt).eps, rdt)
        # scaled local sum + psum of (scale, partial): the naive local sum of
        # squares overflows f32-range for entries ~1e19 (c64 compute dtype)
        mloc = jax.lax.pmax(jnp.max(jnp.abs(a_loc)).real.astype(rdt),
                            MODEL_AXIS)
        sc = jnp.maximum(mloc, jnp.asarray(1e-30, rdt))
        z_loc = (jnp.abs(a_loc).real.astype(rdt) / sc)
        fro2s = jax.lax.psum(jnp.sum(z_loc * z_loc), MODEL_AXIS)
        floor = 5.0 * eps * jnp.sqrt(jnp.asarray(float(max(mrows, n)), rdt)) \
            * jnp.maximum(sc * jnp.sqrt(fro2s / min(mrows, n)),
                          jnp.asarray(1e-30, rdt))

        def cond(carry):
            _, _, _, resid, it, _, stall = carry
            mx = jnp.max(resid)
            return (it < iterations) & (mx > floor) & (stall < 6)

        def body(carry):
            v_loc, U, sigma, resid, it, best_max, stall = carry
            v_loc, U, sigma = round_once(v_loc)
            resid = two_sided_resid(v_loc, U, sigma)
            mx = jnp.max(resid)
            improved = mx < 0.97 * best_max
            stall = jnp.where(improved, 0, stall + 1)
            best_max = jnp.minimum(mx, best_max)
            return v_loc, U, sigma, resid, it + 1, best_max, stall

        carry0 = (vslice(v0), jnp.zeros((mrows, k), dtype),
                  jnp.zeros((k,), rdt), jnp.full((k,), jnp.inf, rdt),
                  jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, rdt),
                  jnp.asarray(0, jnp.int32))
        v_loc, U, sigma, resid, _, _, _ = jax.lax.while_loop(
            cond, body, carry0)
        # replicate V: disjoint column supports → scatter + psum (psum output
        # is statically replication-typed, unlike all_gather)
        vfull = jax.lax.dynamic_update_slice(
            jnp.zeros((k, n), dtype), v_loc, (me * 0, me * c))
        V = jax.lax.psum(vfull, MODEL_AXIS)
        return sigma, U, V, resid.astype(rdt)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, MODEL_AXIS), P()),
                         out_specs=(P(), P(), P(), P()))(A, V0)


def svd_distributed(mesh: Mesh, A, num_candidates: int = 8,
                    iterations: int = 30, seed: int = 0):
    """INTERNAL FALLBACK: bare block-subspace-iteration driver (no MAUS
    meta-heuristic, no finisher). The production mesh entry point is
    ``maus_tpu.svd(A, mesh=...)`` (solver/api._svd_mesh), which runs the FULL
    engine over a GSPMD-sharded operand — use this driver only for isolated
    testing of the sharded block round.

    Returns host arrays ``(sigma, U, V, resids)``: k Ritz singular values
    (descending), left vectors (M, k), right vectors (k, N), and two-sided
    residuals. Per-device memory ≈ M·N·8/m bytes for the A shard; everything
    else is O((M+N)·k).
    """
    import numpy as np

    from ..core import backend

    mrows, n = A.shape[-2], A.shape[-1]
    m = mesh.shape[MODEL_AXIS]
    if n % m != 0:
        raise ValueError(f"N={n} must divide by model axis {m}")
    k = min(num_candidates, mrows, n)
    col_shard = NamedSharding(mesh, P(None, MODEL_AXIS))
    if not hasattr(A, "sharding"):
        A = np.asarray(A).astype(backend.default_complex_dtype())
    A = jax.device_put(A, col_shard)

    sigma, U, V, resid = _svd_iterate(mesh, A, jax.random.PRNGKey(seed), k,
                                      iterations)
    sig_host = np.asarray(sigma, np.float64)
    ur = np.asarray(jax.jit(lambda z: z.real)(U), np.float64)
    ui = np.asarray(jax.jit(lambda z: z.imag)(U), np.float64)
    vr = np.asarray(jax.jit(lambda z: z.real)(V), np.float64)
    vi = np.asarray(jax.jit(lambda z: z.imag)(V), np.float64)
    return sig_host, ur + 1j * ui, vr + 1j * vi, np.asarray(resid, np.float64)
