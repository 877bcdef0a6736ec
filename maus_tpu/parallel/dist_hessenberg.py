"""Distributed (column-sharded) Hessenberg reduction + shifted solves + eig.

Completes the distributed story for the EIGENVALUE path. The single-device
eig hot path (ops/hessenberg.py) reduces A = Q H Qᴴ
once and then runs every per-candidate shifted solve in O(N²); here the same
two stages run with **A, H, Q and the per-candidate working set all
column-sharded over the mesh's model axis**, so per-device memory is
≈ (2·N² + K·N²)/m and an eig operand larger than one device's memory reduces and
iterates in place — the eig-path counterpart of ``parallel/dist_qr.py``.

Algorithm / communication budget (per reduction step j, N−2 steps):

* broadcast of column j of H (owner → all, one masked ``psum`` of N values);
* the LEFT reflector update H ← H − 2·v·(vᴴH) is embarrassingly column-local;
* the RIGHT update H ← H − 2·(Hv)·vᴴ needs Hv: one ``psum`` of N (each device
  contributes H_loc @ v[its columns]); same for the Q accumulation.

Total O(N²) communication for the O(N³) reduction — the same ratio as
``dist_qr`` and as one all-gather of A.

The shifted-solve sweep (``dist_hess_solve``) keeps the per-candidate R
factors column-sharded; rotations apply locally to (K, C) row slices and only
the per-column pivot pair (O(K) values) crosses the interconnect per step.
It is latency-bound (2N psums of K scalars) and therefore meant for operands
that *cannot* fit one device — at single-device sizes ``ops/hessenberg``
(zero collectives) is strictly faster; ``eig()``'s mesh router picks
accordingly.

Reference parity: this distributes the reference's per-candidate
``(A − λI)w = v`` core (AMS:258-283, LAPACK ``sla.solve`` at AMS:59). The
reference itself has no distributed capability at all (SURVEY.md §2.3).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import MODEL_AXIS


class DistHess(NamedTuple):
    """Column-sharded Hessenberg form: A = Q H Qᴴ, both P(None, model)."""

    h: jax.Array
    q: jax.Array


def _axis_me():
    return jax.lax.axis_index(MODEL_AXIS)


def _bcast_col(owner, col):
    """Broadcast a locally-extracted column from its owner (masked psum)."""
    return jax.lax.psum(
        jnp.where(_axis_me() == owner, col, jnp.zeros_like(col)), MODEL_AXIS)


@partial(jax.jit, static_argnames=("mesh",))
def dist_hessenberg(mesh: Mesh, A: jax.Array) -> DistHess:
    """Reduce a column-sharded square A to upper-Hessenberg form.

    Same Householder similarity chain as the single-chip
    :func:`maus_tpu.ops.hessenberg.reduce_hessenberg` (same v construction,
    same sign convention) with the two GEMV-rank-1 updates split over column
    shards. Requires N divisible by the model-axis size.
    """
    n = A.shape[0]
    m = mesh.shape[MODEL_AXIS]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"dist_hessenberg needs a square operand, got {A.shape}")
    if n % m != 0:
        raise ValueError(f"N={n} must be divisible by the model axis ({m})")
    c = n // m
    dtype = A.dtype
    rdt = jnp.finfo(dtype).dtype
    rows = jnp.arange(n)

    def local(a_loc):
        me = _axis_me()
        gcols = me * c + jnp.arange(c)      # global indices of local columns

        def vslice(v):
            """The local-column slice of a replicated (N,) vector."""
            return jax.lax.dynamic_slice(v, (me * c,), (c,))

        def step(carry, j):
            H, Q = carry
            owner = j // c
            colj = _bcast_col(owner,
                              jax.lax.dynamic_slice(H, (0, j % c),
                                                    (n, 1))[:, 0])
            tail = rows > j
            x = jnp.where(tail, colj, 0.0)
            normx = jnp.linalg.norm(x)
            pivot = jnp.sum(jnp.where(rows == j + 1, x, 0.0))
            absp = jnp.abs(pivot)
            sign = jnp.where(absp > 0, pivot / jnp.maximum(absp, 1e-30),
                             jnp.ones_like(pivot))
            beta = -sign * normx.astype(dtype)
            v = x - beta * (rows == j + 1).astype(dtype)
            vn = jnp.linalg.norm(v)
            ok = (vn.real > jnp.asarray(1e-30, rdt)) & \
                 (normx.real > jnp.asarray(1e-30, rdt))
            v = jnp.where(ok, v / jnp.maximum(
                vn, jnp.asarray(1e-30, rdt).astype(vn.dtype)), 0.0)
            hi = jax.lax.Precision.HIGHEST
            # left:  H ← H − 2 v (vᴴ H)   — column-local
            w_loc = jnp.matmul(jnp.conj(v), H, precision=hi)          # (C,)
            H = H - 2.0 * jnp.outer(v, w_loc)
            # right: H ← H − 2 (H v) vᴴ   — one psum for the matvec
            u = jax.lax.psum(jnp.matmul(H, vslice(v), precision=hi),
                             MODEL_AXIS)                              # (N,)
            H = H - 2.0 * jnp.outer(u, jnp.conj(vslice(v)))
            # accumulate Q ← Q (I − 2 v vᴴ)
            qv = jax.lax.psum(jnp.matmul(Q, vslice(v), precision=hi),
                              MODEL_AXIS)
            Q = Q - 2.0 * jnp.outer(qv, jnp.conj(vslice(v)))
            return (H, Q), None

        q0 = (rows[:, None] == gcols[None, :]).astype(dtype)   # local I cols
        (H, Q), _ = jax.lax.scan(step, (a_loc, q0),
                                 jnp.arange(max(n - 2, 0)))
        # zero sub-subdiagonal rounding dust (local: global column indices)
        H = jnp.where(rows[:, None] > gcols[None, :] + 1, 0.0, H)
        return H, Q

    h, q = jax.shard_map(local, mesh=mesh,
                         in_specs=P(None, MODEL_AXIS),
                         out_specs=(P(None, MODEL_AXIS),
                                    P(None, MODEL_AXIS)))(A)
    return DistHess(h=h, q=q)


@partial(jax.jit, static_argnames=("mesh",))
def dist_hess_solve(mesh: Mesh, H: jax.Array, lams: jax.Array,
                    B: jax.Array, psi: jax.Array | None = None) -> jax.Array:
    """Solve ``(H − λ_k I + ψ_k I) w_k = b_k`` with H column-sharded.

    Distributed Givens QR sweep: the per-candidate triangular factors R stay
    column-sharded ((K, N, C) per device — the memory that forces the
    distribution); each step rotates local (K, C) row slices and psums only
    the (K,)-sized pivot pair. Back substitution mirrors it (local partial
    dots + one (K,) psum per column). B and the returned solutions are
    replicated (they are K·N — small next to the K·N²/m factors).
    """
    K, n = B.shape
    m = mesh.shape[MODEL_AXIS]
    if n % m != 0:
        raise ValueError(f"N={n} must be divisible by the model axis ({m})")
    c = n // m
    dtype = B.dtype
    rdt = jnp.finfo(dtype).dtype
    shift = -lams.astype(dtype)
    if psi is not None:
        shift = shift + psi.astype(dtype)

    def local(h_loc, shift_, b):
        me = _axis_me()
        gcols = me * c + jnp.arange(c)                 # (C,) global col ids

        def getcol(M2d, j):
            """Broadcast global column j of a (K, C)-local array: (K,)."""
            return _bcast_col(j // c,
                              jax.lax.dynamic_slice_in_dim(
                                  M2d, j % c, 1, axis=-1)[..., 0])

        # R rows are written once per step (rotated row j); the carry holds
        # the local column slice of the working row j+1 and the rhs element.
        def fwd(carry, j):
            R, cur, ycur = carry                       # (K,N,C), (K,C), (K,)
            hrow = jax.lax.dynamic_slice_in_dim(h_loc, j + 1, 1,
                                                axis=0)            # (1, C)
            fresh = jnp.broadcast_to(hrow, (K, c)) + \
                shift_[:, None] * (gcols[None, :] == j + 1).astype(dtype)
            a = getcol(cur, j)                                     # (K,)
            bb = jax.lax.psum(
                jnp.sum(jnp.where(gcols == j, hrow[0], 0.0)), MODEL_AXIS)
            r2 = (jnp.abs(a) ** 2 + jnp.abs(bb) ** 2).real
            r = jnp.sqrt(jnp.maximum(r2, jnp.asarray(1e-30, rdt)))
            nontriv = jnp.abs(bb) > 0
            absa = jnp.abs(a)
            signa = jnp.where(absa > 0, a / jnp.maximum(absa, 1e-30),
                              jnp.ones_like(a))
            cg = jnp.where(nontriv, (absa / r).astype(dtype),
                           jnp.ones_like(a))
            sg = jnp.where(nontriv, signa * jnp.conj(bb) / r.astype(dtype),
                           jnp.zeros_like(a))
            row0 = cg[:, None] * cur + sg[:, None] * fresh
            row1 = -jnp.conj(sg)[:, None] * cur + \
                jnp.conj(cg)[:, None] * fresh
            R = jax.lax.dynamic_update_slice(R, row0[:, None, :], (0, j, 0))
            yfresh = jax.lax.dynamic_slice_in_dim(b, j + 1, 1,
                                                  axis=1)[:, 0]    # (K,)
            y0 = cg * ycur + sg * yfresh
            y1 = -jnp.conj(sg) * ycur + jnp.conj(cg) * yfresh
            return (R, row1, y1), y0

        cur0 = jnp.broadcast_to(h_loc[0:1], (K, c)) + \
            shift_[:, None] * (gcols[None, :] == 0).astype(dtype)
        ycur0 = jax.lax.pcast(b[:, 0], (MODEL_AXIS,), to="varying")
        R0 = jax.lax.pcast(jnp.zeros((K, n, c), dtype), (MODEL_AXIS,),
                           to="varying")
        (R, cur, ycur), ys = jax.lax.scan(
            fwd, (R0, cur0, ycur0), jnp.arange(max(n - 1, 0)))
        R = jax.lax.dynamic_update_slice(R, cur[:, None, :], (0, n - 1, 0))
        y = jnp.concatenate([ys.T, ycur[:, None]], axis=-1)       # (K, N)

        def bwd(x, j):
            Rj = jax.lax.dynamic_slice_in_dim(R, j, 1, axis=1)[:, 0]  # (K, C)
            mask_gt = (gcols[None, :] > j).astype(rdt)
            dot = jax.lax.psum(jnp.sum(Rj * x * mask_gt, axis=-1),
                               MODEL_AXIS)                        # (K,)
            rjj = jax.lax.psum(
                jnp.sum(jnp.where(gcols[None, :] == j, Rj, 0.0), axis=-1),
                MODEL_AXIS)
            yj = jax.lax.dynamic_slice_in_dim(y, j, 1, axis=1)[:, 0]
            safe = jnp.abs(rjj) > 0
            xj = jnp.where(safe, (yj - dot) / jnp.where(safe, rjj, 1.0),
                           jnp.asarray(jnp.inf, dtype))
            x = x + xj[:, None] * (gcols[None, :] == j).astype(dtype)
            return x, None

        x0 = jax.lax.pcast(jnp.zeros((K, c), dtype), (MODEL_AXIS,),
                           to="varying")
        x, _ = jax.lax.scan(bwd, x0, jnp.arange(n - 1, -1, -1))
        # replicate the solution: column supports are disjoint per device, so
        # scattering into the full width and psum-ing reassembles it (and the
        # psum output is statically replication-typed, unlike all_gather)
        xfull = jax.lax.dynamic_update_slice(
            jnp.zeros((K, n), dtype), x, (me * 0, me * c))
        return jax.lax.psum(xfull, MODEL_AXIS)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, MODEL_AXIS), P(), P()),
                         out_specs=P())(H, shift, B)


@partial(jax.jit, static_argnames=("mesh",))
def _dist_matvec_adj(mesh: Mesh, M: jax.Array, X: jax.Array) -> jax.Array:
    """Rows of the result are Mᴴ x_k: X @ conj(M) for column-sharded M (N, N)
    and replicated X (K, N). The products are column-local; the disjoint
    column supports reassemble with one psum (statically replication-typed)."""
    n = M.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m

    def local(m_loc, x):
        hi = jax.lax.Precision.HIGHEST
        me = _axis_me()
        out_loc = jnp.matmul(x, jnp.conj(m_loc), precision=hi)   # (K, C)
        full = jax.lax.dynamic_update_slice(
            jnp.zeros((x.shape[0], n), m_loc.dtype), out_loc, (me * 0, me * c))
        return jax.lax.psum(full, MODEL_AXIS)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, MODEL_AXIS), P()),
                         out_specs=P())(M, X)


@partial(jax.jit, static_argnames=("mesh",))
def dist_solve_shifted(mesh: Mesh, hess: DistHess, lams: jax.Array,
                       B: jax.Array, psi: jax.Array | None = None
                       ) -> jax.Array:
    """(A − λ_k I + ψ_k I)⁻¹ b_k against the COLUMN-SHARDED Hessenberg form —
    the distributed counterpart of ops.hessenberg.solve_shifted_via_hessenberg,
    used by the full MAUS engine's eig step when a mesh is passed
    (solver/evolve.make_iteration): rows = Q · (H − λI + ψ)⁻¹ · Qᴴ b."""
    Bh = _dist_matvec_adj(mesh, hess.q, B)          # rows = Qᴴ b_k
    W = dist_hess_solve(mesh, hess.h, lams, Bh, psi)
    return _dist_matvec_rows(mesh, hess.q, W)       # rows = Q w_k


@partial(jax.jit, static_argnames=("mesh",))
def _dist_matvec_rows(mesh: Mesh, M: jax.Array, X: jax.Array) -> jax.Array:
    """X @ M.T for column-sharded M (N, N) and replicated X (K, N); one psum.
    Returns the replicated (K, N) result."""
    n = M.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m

    def local(m_loc, x):
        hi = jax.lax.Precision.HIGHEST
        me = _axis_me()
        x_loc = jax.lax.dynamic_slice(x, (me * 0, me * c), (x.shape[0], c))
        return jax.lax.psum(jnp.matmul(x_loc, m_loc.T, precision=hi),
                            MODEL_AXIS)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, MODEL_AXIS), P()),
                         out_specs=P())(M, X)


@partial(jax.jit, static_argnames=("mesh",))
def _spectrum_moments(mesh: Mesh, H: jax.Array):
    """(lam_center, lam_scale, psi0) from the sharded H — H is similar to A,
    so tr(H) and ‖H‖_F match A's and the moment-matched shift init of
    ``candidate.init_population`` carries over."""
    n = H.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m
    rdt = jnp.finfo(H.dtype).dtype

    def local(h_loc):
        me = _axis_me()
        gcols = me * c + jnp.arange(c)
        diag = jnp.sum(jnp.where(
            jnp.arange(n)[:, None] == gcols[None, :], h_loc, 0.0))
        fro2 = jnp.sum(jnp.abs(h_loc) ** 2).real
        return (jax.lax.psum(diag, MODEL_AXIS),
                jax.lax.psum(fro2, MODEL_AXIS))

    tr, fro2 = jax.shard_map(local, mesh=mesh,
                             in_specs=P(None, MODEL_AXIS),
                             out_specs=(P(), P()))(H)
    lam_center = tr / n
    lam_scale = jnp.sqrt(jnp.maximum(
        fro2 / n - (jnp.abs(lam_center) ** 2).real, 1e-12)).astype(rdt)
    eps = jnp.asarray(jnp.finfo(rdt).eps, rdt)
    psi0 = jnp.sqrt(fro2 / n).astype(rdt) * eps * eps * 1e6
    return lam_center, lam_scale, psi0


@partial(jax.jit, static_argnames=("mesh", "k", "iterations"))
def _eig_iterate(mesh: Mesh, hess: DistHess, key: jax.Array, k: int,
                 iterations: int, lam_center, lam_scale, psi0):
    """Shifted inverse iteration with Rayleigh-quotient updates against the
    column-sharded H — K candidates batched, all solves distributed."""
    n = hess.h.shape[0]
    dtype = hess.h.dtype
    rdt = jnp.finfo(dtype).dtype

    kv, kl = jax.random.split(key)
    kvr, kvi = jax.random.split(kv)
    V = jax.lax.complex(jax.random.normal(kvr, (k, n), rdt),
                        jax.random.normal(kvi, (k, n), rdt)).astype(dtype)
    V = V / jnp.linalg.norm(V, axis=-1, keepdims=True)
    klr, kli = jax.random.split(kl)
    lam = (jax.lax.complex(jax.random.normal(klr, (k,), rdt),
                           jax.random.normal(kli, (k,), rdt))
           * lam_scale).astype(dtype) + lam_center

    psi_v = jnp.full((k,), 1.0, rdt) * psi0

    # ``iterations`` is an upper BOUND (consistent with evolve_while's
    # semantics): each distributed iteration costs a 2N-step latency-bound
    # collective scan, so running a fixed count after convergence would waste
    # minutes of collective wall-clock at large N. Stop when the worst candidate
    # residual falls below the dtype floor or stalls.
    eps = jnp.asarray(jnp.finfo(rdt).eps, rdt)
    scale = (jnp.abs(lam_center) + lam_scale).real.astype(rdt)
    floor = 5.0 * eps * jnp.sqrt(jnp.asarray(float(n), rdt)) * \
        jnp.maximum(scale, jnp.asarray(1e-30, rdt))

    def cond(carry):
        _, _, resid, it, _, stall = carry
        mx = jnp.max(resid)
        return (it < iterations) & (mx > floor) & (stall < 6)

    def body(carry):
        V, lam, resid, it, best_max, stall = carry
        W = dist_hess_solve(mesh, hess.h, lam, V, psi=psi_v)
        Wn = W / jnp.maximum(jnp.linalg.norm(W, axis=-1, keepdims=True),
                             jnp.finfo(rdt).tiny)
        good = jnp.all(jnp.isfinite(Wn.real) & jnp.isfinite(Wn.imag),
                       axis=-1, keepdims=True)
        V = jnp.where(good, Wn, V)
        HV = _dist_matvec_rows(mesh, hess.h, V)
        lam = jnp.sum(jnp.conj(V) * HV, axis=-1)
        resid = jnp.linalg.norm(HV - lam[:, None] * V, axis=-1).real
        mx = jnp.max(resid)
        improved = mx < 0.97 * best_max
        stall = jnp.where(improved, 0, stall + 1)
        best_max = jnp.minimum(mx, best_max)
        return V, lam, resid, it + 1, best_max, stall

    resid0 = jnp.full((k,), jnp.inf, rdt)
    V, lam, resid, _, _, _ = jax.lax.while_loop(
        cond, body, (V, lam, resid0, jnp.asarray(0, jnp.int32),
                     jnp.asarray(jnp.inf, rdt), jnp.asarray(0, jnp.int32)))
    return V, lam, resid


@partial(jax.jit, static_argnames=("mesh",))
def _back_map_normalize(mesh: Mesh, Q: jax.Array, V: jax.Array):
    """Eigenvectors of A: x_k = Q v_k (rows), normalized; one psum."""
    n = Q.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m

    def local(q_loc, v):
        hi = jax.lax.Precision.HIGHEST
        me = _axis_me()
        v_loc = jax.lax.dynamic_slice(v, (me * 0, me * c), (v.shape[0], c))
        return jax.lax.psum(jnp.matmul(v_loc, q_loc.T, precision=hi),
                            MODEL_AXIS)

    X = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(None, MODEL_AXIS), P()),
                      out_specs=P())(Q, V)
    return X / jnp.linalg.norm(X, axis=-1, keepdims=True)


@partial(jax.jit, static_argnames=("mesh",))
def _resid_against_A(mesh: Mesh, A: jax.Array, X: jax.Array, lam: jax.Array):
    AX = _dist_matvec_rows(mesh, A, X)
    return jnp.linalg.norm(AX - lam[:, None] * X, axis=-1).real


def eig_distributed(mesh: Mesh, A, num_candidates: int = 16,
                    iterations: int = 30, seed: int = 0):
    """INTERNAL FALLBACK: plain shifted-inverse-iteration driver (no MAUS
    meta-heuristic, no finisher). The production mesh entry point is
    ``maus_tpu.eig(A, mesh=...)``, which runs the FULL engine over the same
    sharded Hessenberg machinery (solver/api._eig_mesh) — use this driver
    only for isolated testing of the sharded reduction/solve kernels.

    Returns host arrays ``(lams, vecs, resids)``: per-candidate eigenvalue
    estimates, eigenvectors of A (rows), and ‖Av − λv‖ residuals measured
    against the sharded A. Per-device memory ≈ (3 + K)·N²·8/m bytes.
    """
    import numpy as np

    from ..core import backend
    from ..utils.xfer import to_host_complex

    n = A.shape[0]
    m = mesh.shape[MODEL_AXIS]
    if n % m != 0:
        raise ValueError(f"N={n} must divide by model axis {m}")
    col_shard = NamedSharding(mesh, P(None, MODEL_AXIS))
    if not hasattr(A, "sharding"):
        # same compute-dtype rule as MausSolver (solver/api.py)
        A = np.asarray(A).astype(backend.default_complex_dtype())
    A = jax.device_put(A, col_shard)
    hess = dist_hessenberg(mesh, A)

    lam_center, lam_scale, psi0 = _spectrum_moments(mesh, hess.h)
    V, lam, _ = _eig_iterate(mesh, hess, jax.random.PRNGKey(seed),
                             num_candidates, iterations,
                             lam_center, lam_scale, psi0)
    X = _back_map_normalize(mesh, hess.q, V)
    res = _resid_against_A(mesh, A, X, lam)

    return (to_host_complex(lam).astype(np.complex128),
            to_host_complex(X).astype(np.complex128),
            np.asarray(res, np.float64))
