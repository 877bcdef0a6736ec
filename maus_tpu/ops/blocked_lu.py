"""From-scratch blocked LU with partial pivoting (right-looking, panel form).

No library code builds these factorizations (ROADMAP D6); the shared linear
factorization is QR (``batched_solve.factor_qr``). Everything here contracts
at ``Precision.HIGHEST``, so the backward error is f32-grade like any
textbook partially-pivoted LU.

Structure (classic LAPACK ``getrf`` blocking):
the panel loop is unrolled in Python (static shapes per panel — no dynamic
slice sizes), the within-panel column loop is a ``lax.fori_loop`` on the
fixed-shape (N, b) panel, row swaps are recorded per panel and applied as ONE
gather of the full matrix (the permutation simulation is an O(b) scan on an
int32 index vector), and the trailing update is a single
``L21 @ U12`` GEMM per panel — where all the flops live.

Complex LU costs (8/3)·N³ real FLOPs vs QR's (16/3)·N³: at equal achieved
efficiency the factorization halves.

Reference parity: this is the device equivalent of the reference's dense direct
path — LAPACK ``getrf/getrs`` behind ``sla.solve(assume_a='general')``
(Adaptive_Matrix_Solver_0.1.py:59).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsla

_HI = jax.lax.Precision.HIGHEST


class BlockedLU(NamedTuple):
    """Packed LU factors of P·H = L·U.

    ``lu``   — (N, N): unit-lower L below the diagonal, U on/above.
    ``perm`` — (N,) int32: row i of ``lu`` holds row ``perm[i]`` of H
               (apply to a rhs as ``b[perm]``).
    """

    lu: jax.Array
    perm: jax.Array


def _abs2(x):
    if jnp.iscomplexobj(x):
        return jnp.real(x) * jnp.real(x) + jnp.imag(x) * jnp.imag(x)
    return x * x


def _factor_panel(panel: jax.Array, j0: int):
    """Partially-pivoted LU of an (N, b) panel whose diagonal block starts at
    global row ``j0``.  Returns (factored panel, (b,) int32 swap targets —
    swap_rows[c] is the global row exchanged with row j0+c at step c)."""
    n, b = panel.shape
    rows = jnp.arange(n)

    zero = jnp.zeros((), jnp.int32)

    def col_step(c, carry):
        P, swaps = carry
        c = c.astype(jnp.int32)
        j = jnp.int32(j0) + c
        col = jax.lax.dynamic_slice(P, (zero, c), (n, 1))[:, 0]
        # pivot: max |entry| over rows >= j (strictly below the already-
        # factored part)
        mag = jnp.where(rows >= j, _abs2(col), -1.0)
        p = jnp.argmax(mag).astype(jnp.int32)
        # swap rows j and p of the whole panel
        row_j = jax.lax.dynamic_slice(P, (j, zero), (1, b))
        row_p = jax.lax.dynamic_slice(P, (p, zero), (1, b))
        P = jax.lax.dynamic_update_slice(P, row_p, (j, zero))
        P = jax.lax.dynamic_update_slice(P, row_j, (p, zero))
        swaps = swaps.at[c].set(p)
        # scale the sub-diagonal of column c; the guard stays inside f32's
        # exponent range so it also holds for f32 factors
        piv = jax.lax.dynamic_slice(P, (j, c), (1, 1))[0, 0]
        safe = jnp.where(_abs2(piv) > 1e-30, piv, jnp.ones((), P.dtype))
        colv = jax.lax.dynamic_slice(P, (zero, c), (n, 1))[:, 0]
        l = jnp.where(rows > j, colv / safe, jnp.zeros((), P.dtype))
        P = jax.lax.dynamic_update_slice(
            P, jnp.where(rows > j, l, colv)[:, None], (zero, c))
        # rank-1 update of the columns right of c, rows below j
        u_row = jax.lax.dynamic_slice(P, (j, zero), (1, b))[0]
        cols = jnp.arange(b)
        u = jnp.where(cols > c, u_row, jnp.zeros((), P.dtype))
        P = P - jnp.outer(l, u)
        return P, swaps

    swaps0 = jnp.zeros((b,), jnp.int32)
    return jax.lax.fori_loop(0, b, col_step, (panel, swaps0))


def _swaps_to_gather(swaps: jax.Array, j0: int, n: int) -> jax.Array:
    """Compose the panel's sequential row swaps into one LOCAL gather index
    over rows [j0, n): ``M_new[j0:] = M_old[j0:][idx]``.  Swaps never touch
    rows above the panel, so the gather (the factorization's only non-GEMM
    HBM traffic) skips the already-factored rows."""
    b = swaps.shape[0]

    def step(c, idx):
        j = j0 + c                      # global row of this step
        p = swaps[c]
        vj = idx[j - j0]
        vp = idx[p - j0]
        idx = idx.at[j - j0].set(vp)
        idx = idx.at[p - j0].set(vj)
        return idx

    return jax.lax.fori_loop(0, b, step,
                             jnp.arange(n - j0, dtype=jnp.int32))


def factor_lu(H: jax.Array, block: int = 256) -> BlockedLU:
    """Blocked right-looking LU with partial pivoting of a square matrix."""
    n = H.shape[0]
    assert H.shape == (n, n), f"square operand required, got {H.shape}"
    b = min(block, n)
    npad = ((n + b - 1) // b) * b
    if npad != n:
        # identity extension: pad columns are e_j (pivot onto their own 1),
        # pad rows are zero in real columns (never selected by pivoting)
        M = jnp.zeros((npad, npad), H.dtype)
        M = M.at[:n, :n].set(H)
        M = M.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    else:
        M = H
    perm = jnp.arange(npad, dtype=jnp.int32)

    for k in range(npad // b):
        j0 = k * b
        panel = jax.lax.slice(M, (0, j0), (npad, j0 + b))
        panel, swaps = _factor_panel(panel, j0)
        idx = _swaps_to_gather(swaps, j0, npad)
        # one gather of rows [j0:) applies all b swaps (laswp)
        perm = perm.at[j0:].set(perm[j0:][idx])
        M = M.at[j0:].set(M[j0:][idx])
        M = jax.lax.dynamic_update_slice(M, panel, (0, j0))
        if j0 + b < npad:
            L11 = jax.lax.slice(M, (j0, j0), (j0 + b, j0 + b))
            A12 = jax.lax.slice(M, (j0, j0 + b), (j0 + b, npad))
            U12 = jsla.solve_triangular(L11, A12, lower=True,
                                        unit_diagonal=True)
            L21 = jax.lax.slice(M, (j0 + b, j0), (npad, j0 + b))
            A22 = jax.lax.slice(M, (j0 + b, j0 + b), (npad, npad))
            A22 = A22 - jnp.matmul(L21, U12, precision=_HI)
            M = jax.lax.dynamic_update_slice(M, U12, (j0, j0 + b))
            M = jax.lax.dynamic_update_slice(M, A22, (j0 + b, j0 + b))

    if npad != n:
        M = M[:n, :n]
        perm = perm[:n]
    return BlockedLU(M, perm)


# ---------------------------------------------------------------------------
# RBT + block-local-pivoted LU: the latency-free variant
# ---------------------------------------------------------------------------
#
# The fully-pivoted factor_lu above pays ~N sequential fori steps for its
# panel factorization (the column loop is launch-latency-bound). This
# variant removes per-COLUMN work entirely:
#
#   * a depth-2 RANDOM BUTTERFLY TRANSFORM (Parker '95; Baboulin et al.,
#     "Accelerating linear system solutions using randomization") makes
#     pivot-free elimination stable with high probability: A' = Uᴴ A V with
#     U, V unitary butterflies of random unit-modulus diagonals; solving
#     A x = b becomes  A' y = Uᴴ b,  x = V y.  Applying a depth-d butterfly
#     is O(d·N²) elementwise — no GEMMs, two passes over A per side.
#   * the blocked elimination then factors only the b×b DIAGONAL block per
#     panel (XLA's small LU), keeping partial pivoting WITHIN the block (free safety
#     on top of the RBT), and everything else is trsm-by-explicit-inverse
#     GEMMs: L21 = A21 U11⁻¹, U12 = L11⁻¹ A12, A22 −= L21 U12.
#
# Sequential depth: N/b small LUs instead of N column steps. The production
# integration certifies every solve with a true split-f64 residual and falls
# back to QR on stall, so the with-high-probability stability is checked, not
# assumed.


class RBTLU(NamedTuple):
    """Butterfly-transformed block-LU bundle: ``lu``/``perm`` factor
    A' = Uᴴ A V; ``u_diags``/``v_diags`` are the (depth, N) butterfly
    diagonals of U and V."""

    lu: jax.Array
    perm: jax.Array
    u_diags: jax.Array
    v_diags: jax.Array


def _butterfly_apply(x: jax.Array, diags: jax.Array, transpose: bool,
                     conj: bool) -> jax.Array:
    """Apply a depth-d butterfly to the ROWS of x (axis 0).

    W = B_1 · B_2 · … · B_d; level l (0-indexed) splits the rows into 2^l
    contiguous blocks, and each block [t; s] maps through
    B: (1/√2)·[d0·t + d1·s;  d0·t − d1·s]  (diagonals BEFORE the Hadamard).
    With unit-modulus diagonals each level is unitary.

    Modes: (transpose=False) applies W (finest level first);
    (transpose=True) applies Wᵀ = B_dᵀ…B_1ᵀ — structurally the diagonals move
    AFTER the Hadamard step (Bᵀ = (1/√2)[[D0,D0],[D1,−D1]]) and the level
    order reverses. ``conj`` conjugates the diagonals, so
    Wᴴ = (transpose=True, conj=True) = W⁻¹."""
    depth = diags.shape[0]
    n = x.shape[0]
    inv_sqrt2 = jnp.asarray(2.0 ** -0.5, x.dtype)
    levels = range(depth) if transpose else range(depth - 1, -1, -1)
    y = x
    for l in levels:
        blocks = 1 << l
        h = n // (2 * blocks)
        d = jnp.conj(diags[l]) if conj else diags[l]
        yb = y.reshape((blocks, 2 * h) + y.shape[1:])
        db = d.reshape((blocks, 2 * h) + (1,) * (y.ndim - 1))
        if transpose:
            t, s = yb[:, :h], yb[:, h:]
            out = jnp.concatenate([db[:, :h] * (t + s),
                                   db[:, h:] * (t - s)], axis=1)
        else:
            t = yb[:, :h] * db[:, :h]
            s = yb[:, h:] * db[:, h:]
            out = jnp.concatenate([t + s, t - s], axis=1)
        y = (out * inv_sqrt2).reshape(x.shape)
    return y


def _rand_unit_diags(key: jax.Array, depth: int, n: int, dtype) -> jax.Array:
    theta = jax.random.uniform(key, (depth, n), jnp.float32,
                               0.0, 2.0 * 3.14159265)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        # lax.complex keeps the pair in c64 — "re + 1j*im" promotes through
        # c128
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        return jax.lax.complex(jnp.cos(theta).astype(rdt),
                               jnp.sin(theta).astype(rdt)).astype(dtype)
    return jnp.where(theta < 3.14159265, 1.0, -1.0).astype(dtype)


def factor_rbt_lu(H: jax.Array, key: jax.Array | None = None,
                  block: int = 256, depth: int = 2) -> RBTLU:
    """Butterfly-transform H and block-LU-factor the transform (no global
    pivoting; block-local partial pivoting only)."""
    n = H.shape[0]
    assert H.shape == (n, n)
    b = min(block, n)
    # pad to a multiple of both the block and 2^depth (butterfly halving)
    unit = b * (1 << depth) if (b % (1 << depth)) else b
    npad = ((n + unit - 1) // unit) * unit
    if key is None:
        key = jax.random.PRNGKey(0x5bf)
    ku, kv = jax.random.split(key)
    u_diags = _rand_unit_diags(ku, depth, npad, H.dtype)
    v_diags = _rand_unit_diags(kv, depth, npad, H.dtype)

    if npad != n:
        M = jnp.zeros((npad, npad), H.dtype)
        M = M.at[:n, :n].set(H)
        M = M.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    else:
        M = H
    # A' = Uᴴ A V: butterfly the rows by Uᴴ; columns by V via (Vᵀ Aᵀ)ᵀ
    M = _butterfly_apply(M, u_diags, transpose=True, conj=True)
    M = _butterfly_apply(M.T, v_diags, transpose=True, conj=False).T

    perm = jnp.arange(npad, dtype=jnp.int32)
    eye_b = jnp.eye(b, dtype=H.dtype)
    for k in range(npad // b):
        j0 = k * b
        D = jax.lax.slice(M, (j0, j0), (j0 + b, j0 + b))
        lu_d, piv = jsla.lu_factor(D)
        # LAPACK piv (successive row swaps) → local gather index
        def piv_step(c, idx):
            p = piv[c]
            vj, vp = idx[c], idx[p]
            return idx.at[c].set(vp).at[p].set(vj)
        lidx = jax.lax.fori_loop(0, b, piv_step,
                                 jnp.arange(b, dtype=jnp.int32))
        # block-local row swap of the whole panel row-strip + perm
        strip = jax.lax.slice(M, (j0, 0), (j0 + b, npad))[lidx]
        M = jax.lax.dynamic_update_slice(M, strip, (j0, 0))
        perm = perm.at[j0:j0 + b].set(perm[j0:j0 + b][lidx])
        M = jax.lax.dynamic_update_slice(M, lu_d, (j0, j0))
        if j0 + b < npad:
            L11 = jnp.tril(lu_d, -1) + eye_b
            U11 = jnp.triu(lu_d)
            L11_inv = jsla.solve_triangular(L11, eye_b, lower=True,
                                            unit_diagonal=True)
            U11_inv = jsla.solve_triangular(U11, eye_b, lower=False)
            A12 = jax.lax.slice(M, (j0, j0 + b), (j0 + b, npad))
            A21 = jax.lax.slice(M, (j0 + b, j0), (npad, j0 + b))
            U12 = jnp.matmul(L11_inv, A12, precision=_HI)
            L21 = jnp.matmul(A21, U11_inv, precision=_HI)
            A22 = jax.lax.slice(M, (j0 + b, j0 + b), (npad, npad))
            A22 = A22 - jnp.matmul(L21, U12, precision=_HI)
            M = jax.lax.dynamic_update_slice(M, U12, (j0, j0 + b))
            M = jax.lax.dynamic_update_slice(M, L21, (j0 + b, j0))
            M = jax.lax.dynamic_update_slice(M, A22, (j0 + b, j0 + b))

    return RBTLU(M, perm, u_diags, v_diags)


def solve_rbt_lu(fac: RBTLU, rhs: jax.Array, block: int = 1024) -> jax.Array:
    """x = V · (LU-solve of Uᴴ rhs) for the butterfly-transformed factors.
    Handles the identity-extension padding transparently."""
    npad = fac.lu.shape[0]
    n = rhs.shape[0]
    vec = rhs.ndim == 1
    B = rhs[:, None] if vec else rhs
    if npad != n:
        B = jnp.concatenate(
            [B, jnp.zeros((npad - n,) + B.shape[1:], B.dtype)], axis=0)
    Bp = _butterfly_apply(B, fac.u_diags, transpose=True, conj=True)
    Y = solve_lu(BlockedLU(fac.lu, fac.perm), Bp, block=block)
    X = _butterfly_apply(Y, fac.v_diags, transpose=False, conj=False)
    X = X[:n]
    return X[:, 0] if vec else X


def solve_lu(fac: BlockedLU, rhs: jax.Array, block: int = 1024) -> jax.Array:
    """x = U⁻¹ L⁻¹ P rhs.  ``rhs``: (N,) or (N, K).  Blocked substitutions:
    only ``block``-sized diagonal tiles hit the slow triangular-solve
    primitive; the cross terms are GEMMs."""
    lu, perm = fac
    n = lu.shape[0]
    vec = rhs.ndim == 1
    B = rhs[:, None] if vec else rhs
    B = B[perm]
    b = min(block, n)
    nb = (n + b - 1) // b
    # forward: L y = B  (unit lower)
    Y = B
    for k in range(nb):
        lo, hi = k * b, min((k + 1) * b, n)
        Lkk = lu[lo:hi, lo:hi]
        rhs_k = Y[lo:hi]
        if k:
            rhs_k = rhs_k - jnp.matmul(lu[lo:hi, :lo], Y[:lo], precision=_HI)
        yk = jsla.solve_triangular(Lkk, rhs_k, lower=True, unit_diagonal=True)
        Y = Y.at[lo:hi].set(yk)
    # backward: U x = Y
    X = Y
    for k in reversed(range(nb)):
        lo, hi = k * b, min((k + 1) * b, n)
        rhs_k = X[lo:hi]
        if hi < n:
            rhs_k = rhs_k - jnp.matmul(lu[lo:hi, hi:], X[hi:], precision=_HI)
        xk = jsla.solve_triangular(lu[lo:hi, lo:hi], rhs_k, lower=False)
        X = X.at[lo:hi].set(xk)
    return X[:, 0] if vec else X
