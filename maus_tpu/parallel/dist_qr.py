"""Distributed QR factorization + solve (VERDICT r1 #3, SURVEY §7.2 step 7).

GSPMD replicates XLA's QR/LU, so without this module an operand has to fit
one device's memory. This module factorizes a COLUMN-sharded operand in place with a panel
CGS2 (communication-avoiding) blocked QR written in ``shard_map``:

* A, Q, R are all column-sharded over the ``model`` axis — per-device memory is
  ≈ 3·N²/m, so the factorization scales to operands larger than one chip.
* Per b-wide panel: broadcast the owner's panel (one ``psum`` of N·b), project
  against ALL previously computed Q columns twice (CGS2 — the projections are
  local GEMMs against each device's Q shard, combined with one ``psum`` per
  round), then a redundant local Householder QR of the deflated N×b panel.
  Not-yet-computed Q columns are zero, so no masking is needed: they
  contribute nothing to the projections.
* Total communication is O(N²) per factorization — the same as ONE all-gather
  of A — while the O(N³) GEMM work splits m ways and stays GEMM-shaped.

The solve path (``dist_qr_solve``) is y = Qᴴb (local GEMVs + one all-gather)
followed by a column-oriented blocked back-substitution where each panel's R
columns are broadcast from their owner (O(N²/b)·b = O(N²) total).

``solve_distributed`` composes factorization, solve, and split-f64 iterative
refinement (the correction solves reuse the sharded factors) into the
large-N linear entry point.

The reference has no distributed story at all (SURVEY §2.3); this is the
device-mesh equivalent of its LAPACK ``sla.solve`` core (AMS:59) for operands
beyond one device.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsla
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import backend
from ..ops.refine import _LADDER_MEMORY_SHARE
from .mesh import MODEL_AXIS


class DistQR(NamedTuple):
    """Column-sharded QR factors (both (N, N), sharded P(None, model))."""

    q: jax.Array
    r: jax.Array


def _bcast_from(owner, val):
    """Broadcast ``val`` from the device where axis_index == owner (psum-mask)."""
    me = jax.lax.axis_index(MODEL_AXIS)
    return jax.lax.psum(jnp.where(me == owner, val, jnp.zeros_like(val)),
                        MODEL_AXIS)


def dist_qr(mesh: Mesh, A: jax.Array, block: int = 128) -> DistQR:
    """Factor a column-sharded square A = Q R over the mesh's model axis.

    Requires N % (m·block) == 0 (panels align with device column ownership).
    """
    n = A.shape[0]
    m = mesh.shape[MODEL_AXIS]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"dist_qr needs a square operand, got {A.shape}")
    c = n // m                       # local column count
    if n % m != 0 or c % block != 0:
        raise ValueError(f"N={n} must be divisible by model·block "
                         f"({m}·{block})")
    nb = n // block                  # number of global panels

    def local(a_loc):
        """a_loc: (N, C) local columns. Returns (q_loc, r_loc)."""
        rows = jax.lax.broadcasted_iota(jnp.int32, (n, block), 0)
        me = jax.lax.axis_index(MODEL_AXIS)

        def panel_step(j, carry):
            q_loc, r_loc = carry
            owner = (j * block) // c
            loc = (j * block) % c
            mine = me == owner

            B0 = jax.lax.dynamic_slice(a_loc, (0, loc), (n, block))
            B = _bcast_from(owner, jnp.where(mine, B0, jnp.zeros_like(B0)))

            # CGS2 against all previously computed Q columns (zeros elsewhere)
            hi = jax.lax.Precision.HIGHEST
            c1 = jnp.matmul(jnp.conj(q_loc.T), B, precision=hi)     # (C, b)
            B = B - jax.lax.psum(jnp.matmul(q_loc, c1, precision=hi),
                                 MODEL_AXIS)
            c2 = jnp.matmul(jnp.conj(q_loc.T), B, precision=hi)
            B = B - jax.lax.psum(jnp.matmul(q_loc, c2, precision=hi),
                                 MODEL_AXIS)
            coef_loc = c1 + c2                                      # (C, b)
            # global row index of coef = global Q column index (contiguous
            # ownership ⇒ tiled all_gather restores global order)
            coef = jax.lax.all_gather(coef_loc, MODEL_AXIS, axis=0,
                                      tiled=True)                   # (N, b)

            # redundant local QR of the deflated tall panel (cheap: N·b²)
            Qp, Rp = jnp.linalg.qr(B)                               # (N,b),(b,b)
            # R panel columns: projections above the diagonal block, Rp on it
            rcol = jnp.where(rows < j * block, coef, 0.0)
            rcol = jax.lax.dynamic_update_slice(rcol, Rp, (j * block, 0))

            q_new = jax.lax.dynamic_update_slice(q_loc, Qp, (0, loc))
            r_new = jax.lax.dynamic_update_slice(r_loc, rcol, (0, loc))
            q_loc = jnp.where(mine, q_new, q_loc)
            r_loc = jnp.where(mine, r_new, r_loc)
            return q_loc, r_loc

        q0 = jnp.zeros_like(a_loc)
        r0 = jnp.zeros_like(a_loc)
        return jax.lax.fori_loop(0, nb, panel_step, (q0, r0))

    q, r = jax.shard_map(local, mesh=mesh,
                         in_specs=P(None, MODEL_AXIS),
                         out_specs=(P(None, MODEL_AXIS),
                                    P(None, MODEL_AXIS)))(A)
    return DistQR(q=q, r=r)


def dist_qr_solve(mesh: Mesh, fac: DistQR, b: jax.Array,
                  block: int = 128) -> jax.Array:
    """x = R⁻¹ Qᴴ b against column-sharded factors; b and x replicated."""
    n = fac.q.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m
    nb = n // block

    def local(q_loc, r_loc, b_vec):
        hi = jax.lax.Precision.HIGHEST
        y_loc = jnp.matmul(jnp.conj(q_loc.T), b_vec, precision=hi)   # (C,)
        y = jax.lax.all_gather(y_loc, MODEL_AXIS, axis=0, tiled=True)  # (N,)
        me = jax.lax.axis_index(MODEL_AXIS)

        def back_step(i, carry):
            y, x = carry
            j = nb - 1 - i
            owner = (j * block) // c
            loc = (j * block) % c
            rp0 = jax.lax.dynamic_slice(r_loc, (0, loc), (n, block))
            rp = _bcast_from(owner, jnp.where(me == owner, rp0,
                                              jnp.zeros_like(rp0)))
            rjj = jax.lax.dynamic_slice(rp, (j * block, 0), (block, block))
            yj = jax.lax.dynamic_slice(y, (j * block,), (block,))
            xj = jsla.solve_triangular(rjj, yj, lower=False)
            x = jax.lax.dynamic_update_slice(x, xj, (j * block,))
            # eliminate panel j's contribution from the remaining rhs
            upd = jnp.matmul(rp, xj, precision=hi)                   # (N,)
            rows = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
            y = y - jnp.where(rows < j * block, upd, 0.0)
            return y, x

        x0 = jnp.zeros((n,), b_vec.dtype)
        # match the carry's varying-manual-axes type to the body's outputs
        x0 = jax.lax.pcast(x0, (MODEL_AXIS,), to="varying")
        _, x = jax.lax.fori_loop(0, nb, back_step, (y, x0))
        return jax.lax.psum(x, MODEL_AXIS) / jax.lax.axis_size(MODEL_AXIS)

    return jax.shard_map(local, mesh=mesh,
                         in_specs=(P(None, MODEL_AXIS), P(None, MODEL_AXIS),
                                   P()),
                         out_specs=P())(fac.q, fac.r, b)


# ---------------------------------------------------------------------------
# Large-N distributed linear solve: dist QR + split-f64 refinement
# ---------------------------------------------------------------------------

def use_dist_sliced(mesh, Are) -> bool:
    """Dispatch rule for the distributed f64 residual: column-sharded
    exact-slicing bf16 passes where f64 is not native and the PER-SHARD
    ladder fits — both the memory cap and the f32-exact contraction-length
    cap of the dense rule (ops.refine._slices_fit) scale by the mesh factor
    m, because each device holds and contracts only N/m columns."""
    if backend.native_f64() or Are.dtype != jnp.float64:
        return False
    m = mesh.shape[MODEL_AXIS]
    budget = _LADDER_MEMORY_SHARE * backend.device_memory_bytes()
    return 24 * 2 * (Are.size // m) <= budget and \
        Are.shape[1] // m <= 16384 and Are.shape[0] <= 16384


@partial(jax.jit, static_argnames=("mesh", "block", "steps", "sliced"))
def refine_distributed(mesh, fac: DistQR, Are, Aim, bre, bim, x0,
                       block: int, steps: int, tol, sliced: bool = False):
    """Split-f64 iterative refinement of ``x0`` against the full-precision
    split planes, with every correction solve reusing the column-sharded
    factors (the distributed analogue of ``ops.refine.refine_split``).

    ``sliced=True`` computes the f64 residuals with the COLUMN-SHARDED
    exact-slicing bf16 ladder (parallel/dist_refine.py — identical f64
    result without native f64; see ops/refine.py's SlicedMatrix notes).
    Callers pick via
    :func:`use_dist_sliced`. Returns ``(x_re, x_im, rel)``."""
    rdt = Are.dtype
    bnorm = jnp.maximum(jnp.sqrt(jnp.sum(bre * bre + bim * bim)),
                        jnp.asarray(1e-30, rdt))

    def mv(xre, xim):        # A x in split precision; GSPMD shards the GEMVs
        hi = jax.lax.Precision.HIGHEST
        re = jnp.matmul(Are, xre, precision=hi) \
            - jnp.matmul(Aim, xim, precision=hi)
        im = jnp.matmul(Aim, xre, precision=hi) \
            + jnp.matmul(Are, xim, precision=hi)
        return re, im

    if sliced:
        from ..ops.refine import SplitComplex
        from .dist_refine import dist_slice_operand, dist_sliced_residual

        sl_re, sl_im, sigma = dist_slice_operand(mesh,
                                                 SplitComplex(Are, Aim))
        b64 = SplitComplex(bre, bim)

        def residual(xre, xim):
            r = dist_sliced_residual(mesh, sl_re, sl_im, sigma,
                                     SplitComplex(xre, xim), b64)
            return r.re, r.im
    else:
        def residual(xre, xim):
            are_, aim_ = mv(xre, xim)
            return bre - are_, bim - aim_

    def to_c(re_, im_):
        return jax.lax.complex(re_.astype(jnp.float32),
                               im_.astype(jnp.float32)).astype(fac.q.dtype)

    def body(carry):
        xre, xim, rre, rim, rel, _, it = carry
        d = dist_qr_solve(mesh, fac, to_c(rre, rim), block=block)
        xre2 = xre + d.real.astype(rdt)
        xim2 = xim + d.imag.astype(rdt)
        rre2, rim2 = residual(xre2, xim2)
        rel2 = jnp.sqrt(jnp.sum(rre2 ** 2 + rim2 ** 2)) / bnorm
        better = rel2 < rel
        return (jnp.where(better, xre2, xre), jnp.where(better, xim2, xim),
                jnp.where(better, rre2, rre), jnp.where(better, rim2, rim),
                jnp.minimum(rel2, rel), rel, it + 1)

    def cond(carry):
        _, _, _, _, rel, prev, it = carry
        return (it < steps) & (rel > tol) & (rel <= 0.9 * prev)

    xre = x0.real.astype(rdt)
    xim = x0.imag.astype(rdt)
    rre, rim = residual(xre, xim)
    rel0 = jnp.sqrt(jnp.sum(rre ** 2 + rim ** 2)) / bnorm
    xre, xim, _, _, rel, _, _ = jax.lax.while_loop(
        cond, body, (xre, xim, rre, rim, rel0, jnp.asarray(jnp.inf, rdt),
                     jnp.asarray(0, jnp.int32)))
    return xre, xim, rel


@partial(jax.jit, static_argnames=("mesh", "block", "steps"))
def _dist_solve_refined(mesh, A, b, Are, Aim, bre, bim, block, steps, tol):
    fac = dist_qr(mesh, A, block=block)
    x0 = dist_qr_solve(mesh, fac, b, block=block)
    return refine_distributed(mesh, fac, Are, Aim, bre, bim, x0, block,
                              steps, tol,
                              sliced=use_dist_sliced(mesh, Are))


def _staging_dtypes():
    """(split-plane dtype, compute dtype): the compute dtype is the backend's
    default (``backend.default_complex_dtype``) — on CPU with x64 the
    factorization keeps full precision (a forced c64 base factorization needs
    more IR steps and can stall at the eps32·κ contraction limit on
    ill-conditioned systems)."""
    rdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return rdt, backend.default_complex_dtype()


def stage_A(mesh: Mesh, A):
    """Stage the matrix for the distributed linear path: column-sharded
    compute copy PLUS column-sharded full-precision split planes built from
    the ORIGINAL operand — refinement must target the user's system, not its
    c64 rounding. Accepts host arrays or already-device/sharded arrays.
    Returns ``(A_dev, Are, Aim)``."""
    import numpy as np

    rdt, cdtype = _staging_dtypes()
    col_shard = NamedSharding(mesh, P(None, MODEL_AXIS))
    if not hasattr(A, "sharding"):
        # host operand: every piece goes straight to its column shards, so
        # no full-size copy is ever placed on one device
        A_host = np.asarray(A)
        Are = jax.device_put(A_host.real.astype(rdt), col_shard)
        Aim = jax.device_put(A_host.imag.astype(rdt), col_shard)
        A = jax.device_put(A_host.astype(cdtype), col_shard)
    else:
        # already-on-device operand: one jitted program derives the pieces
        Are, Aim, A = jax.jit(
            lambda a: (a.real.astype(rdt), a.imag.astype(rdt),
                       a.astype(cdtype)),
            out_shardings=(col_shard, col_shard, col_shard))(A)
    return jax.device_put(A, col_shard), Are, Aim


def stage_b(mesh: Mesh, b):
    """Stage the rhs (replicated compute copy + full-precision split planes
    from the ORIGINAL data). Returns ``(b_dev, bre, bim)``."""
    import numpy as np

    rdt, cdtype = _staging_dtypes()
    if not hasattr(b, "sharding"):
        b_host = np.asarray(b)
        bre = jnp.asarray(b_host.real.astype(rdt))
        bim = jnp.asarray(b_host.imag.astype(rdt))
        b = jnp.asarray(b_host.astype(cdtype))
    else:
        bre, bim, b = jax.jit(
            lambda x: (x.real.astype(rdt), x.imag.astype(rdt),
                       x.astype(cdtype)))(b)
    return jax.device_put(b, NamedSharding(mesh, P())), bre, bim


def stage_operands(mesh: Mesh, A, b):
    """Shared staging for the distributed solve paths (``solve_distributed``
    and ``maus_tpu.solve(mesh=)``): composes :func:`stage_A` + :func:`stage_b`.

    Returns ``(A_dev, b_dev, Are, Aim, bre, bim)``.
    """
    A_dev, Are, Aim = stage_A(mesh, A)
    b_dev, bre, bim = stage_b(mesh, b)
    return A_dev, b_dev, Are, Aim, bre, bim


def solve_distributed(mesh: Mesh, A, b, tol: float = 1e-8, block: int = 128,
                      refine_steps: int = 30):
    """Solve Ax = b with A column-sharded over the mesh's model axis.

    A and b may be host arrays (placed here) or already-sharded device arrays.
    Returns ``(x_re, x_im, rel)`` split-f64 (f32 without x64) so the refined
    digits survive; ``rel`` is the achieved relative residual.
    """
    A_dev, b_dev, Are, Aim, bre, bim = stage_operands(mesh, A, b)
    return _dist_solve_refined(mesh, A_dev, b_dev, Are, Aim, bre, bim, block,
                               refine_steps, tol)
