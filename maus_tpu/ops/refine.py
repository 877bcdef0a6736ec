"""Mixed-precision iterative refinement.

The evolve loop works in ``complex64``; the user's tolerance (1e-8 relative
residual, BASELINE.md) needs float64 residuals. The recipe:

* factor + solve in ``complex64`` (fast, O(N³));
* hold high-precision iterates as **split re/im float64 pairs**;
* compute residuals ``r = b − A x`` in float64 (O(N²));
* the correction solve ``H d = r`` reuses the c64 factorization.

This reaches ‖Ax−b‖/‖b‖ ≈ 1e-8..1e-15 (κ(A)·eps_f32 < 1 permitting). The
reference has no analogue: it computes in f64 throughout on the CPU.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import backend
from .batched_solve import (CholFactors, LUFactors, QRFactors, solve_chol,
                            solve_factored, solve_qr)


def _solve_any(fac, b):
    if isinstance(fac, FacPlanes):
        fac = fac.combine()
    if isinstance(fac, CholFactors):
        return solve_chol(fac, b)
    if isinstance(fac, QRFactors):
        return solve_qr(fac, b)
    from .blocked_lu import BlockedLU, RBTLU, solve_lu, solve_rbt_lu
    if isinstance(fac, BlockedLU):
        return solve_lu(fac, b)
    if isinstance(fac, RBTLU):
        return solve_rbt_lu(fac, b)
    return solve_factored(fac, b)


class FacPlanes(NamedTuple):
    """A factorization pytree with every complex leaf split into real planes.

    Every refine entry point recombines it on trace, so a caller may hold
    factors in either form (the hoisted Hessenberg cache of large-N eig is
    kept as planes, ``solver/api.py::_hoisted_hessenberg``).
    """

    re: object      # pytree: fac with complex leaves replaced by .real
    im: object      # pytree: .imag for complex leaves, 0-size marker otherwise

    def combine(self):
        # only leaves that were COMPLEX at split time are recombined;
        # real-float and int leaves (a real-operand QR's factors, BlockedLU/
        # RBTLU's int32 perm) ride in `re` verbatim, marked by a zero-size
        # `im` — a STATIC property under jit, so this branch folds at trace
        # time and the markers cost nothing to pass
        return jax.tree.map(
            lambda r, i: jax.lax.complex(r, i) if i.size else r,
            self.re, self.im)


# registered as an ordinary NamedTuple pytree; jit at the call boundary
@jax.jit
def fac_to_planes(fac) -> FacPlanes:
    """Split a factorization's complex leaves into plane pairs (one compiled
    program; callers may then ``delete()`` the complex originals to halve the
    factors' resident footprint before a large refinement program).
    Non-complex leaves (real floats, int perms) ride along in ``re``
    unchanged — dtype preserved — with a zero-size ``im`` marker;
    ``combine()`` restores them verbatim."""
    def _re(z):
        return z.real if jnp.issubdtype(z.dtype, jnp.complexfloating) else z

    def _im(z):
        return (z.imag if jnp.issubdtype(z.dtype, jnp.complexfloating)
                else jnp.zeros((0,), jnp.float32))

    return FacPlanes(jax.tree.map(_re, fac), jax.tree.map(_im, fac))


def _combine_fac(fac):
    return fac.combine() if isinstance(fac, FacPlanes) else fac


class SplitComplex(NamedTuple):
    """A complex vector/matrix held as separate real/imag parts (any float
    dtype): the f64 iterate and residual of refinement, next to a c64
    working copy."""

    re: jax.Array
    im: jax.Array

    @classmethod
    def from_complex(cls, z: jax.Array, dtype=jnp.float64) -> "SplitComplex":
        return cls(z.real.astype(dtype), z.imag.astype(dtype))

    def to_complex(self, dtype=jnp.complex64) -> jax.Array:
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        # lax.complex builds the target dtype directly (no c128 intermediate)
        return jax.lax.complex(self.re.astype(rdt),
                               self.im.astype(rdt)).astype(dtype)

    def norm(self) -> jax.Array:
        # scaled form: |z|/m ≤ 1 keeps the sum of squares in range for any
        # entry size (the naive sum overflows, turning relative residuals
        # into 0/inf). The 1e-30 floor is representable in float32 too, so
        # the guard also holds for f32 planes.
        m = jnp.maximum(jnp.max(jnp.abs(self.re), axis=-1),
                        jnp.max(jnp.abs(self.im), axis=-1))
        safe = jnp.maximum(m, jnp.asarray(1e-30, self.re.dtype))
        r = self.re / safe[..., None]
        i = self.im / safe[..., None]
        return safe * jnp.sqrt(jnp.sum(r * r + i * i, axis=-1))


def scaled_fro(re, im, axis=None):
    """Overflow-safe ‖·‖_F² building block: returns ``(scale, sum((|·|/scale)²))``
    so ``fro2 = scale² · s`` (same scaled form as :meth:`SplitComplex.norm`)."""
    m = jnp.maximum(jnp.max(jnp.abs(re)), jnp.max(jnp.abs(im)))
    scale = jnp.maximum(m, jnp.asarray(1e-30, re.dtype))
    r = re / scale
    i = im / scale
    return scale, jnp.sum(r * r + i * i, axis=axis)


def split_matvec(A: SplitComplex, x: SplitComplex) -> SplitComplex:
    """``A @ x`` on split-complex operands: 4 real matvecs.

    Supports batched ``x`` of shape (..., N) against ``A`` of shape (N, N) via
    standard matmul broadcasting (contract on the last axis of x).
    """
    re = x.re @ A.re.T - x.im @ A.im.T if x.re.ndim > 1 else A.re @ x.re - A.im @ x.im
    im = x.re @ A.im.T + x.im @ A.re.T if x.re.ndim > 1 else A.im @ x.re + A.re @ x.im
    return SplitComplex(re, im)


def split_residual(A: SplitComplex, x: SplitComplex, b: SplitComplex) -> SplitComplex:
    ax = split_matvec(A, x)
    return SplitComplex(b.re - ax.re, b.im - ax.im)


def _residual_3m(A: SplitComplex, Asum: jax.Array, x: SplitComplex,
                 b: SplitComplex) -> SplitComplex:
    """r = b − A x with the 3-multiplication complex trick: Karatsuba on the
    planes (t1 = Ar·xr, t2 = Ai·xi, t3 = (Ar+Ai)(xr+xi)) cuts the f64 GEMVs
    from 4 to 3. ``Asum`` = A.re + A.im, precomputed once per refinement
    call (one O(N²) add amortized over every step)."""
    t1 = A.re @ x.re
    t2 = A.im @ x.im
    t3 = Asum @ (x.re + x.im)
    return SplitComplex(b.re - (t1 - t2), b.im - (t3 - t1 - t2))


# ---------------------------------------------------------------------------
# Exact-slicing (Ozaki-scheme) f64 residual from low-precision products.
#
# For a backend without native f64 (``backend.native_f64()`` False), this
# computes the SAME f64 residual with error-free bf16 products: decompose
# each operand into base-2^w integer slices under a global power-of-two
# scale — every slice is integer-valued with |s| ≤ 2^w, hence EXACT in bf16;
# every product is ≤ 2^{2w} and every length-N f32 accumulation stays
# ≤ 2^{2w}·N < 2^24, hence EXACT with bf16 inputs and f32 accumulation.
# Slicing itself is exact f64 arithmetic (power-of-2 scaling + round-to-int
# subtraction), and with enough slices (⌈53/w⌉ absolute bits below the
# global plane maximum — see slice_split_matrix's docstring) the
# reconstruction in f64 is exact to f64-ADDITION roundoff. See e.g. Ozaki
# et al., "Error-free transformations of matrix multiplication" (Numer.
# Algorithms 59, 2012); Ootomo & Yokota apply the same idea to tensor cores.
#
# Both supported platforms have native f64, so the library no longer takes
# these paths (ROADMAP D2); the CPU tests keep them correct.
# ---------------------------------------------------------------------------

class SlicedMatrix(NamedTuple):
    """Base-2^w integer-sliced split-complex matrix for exact bf16 matvecs."""

    sl_re: jax.Array     # (sA, N, N) bf16, integer-valued
    sl_im: jax.Array
    sigma: jax.Array     # f64 power-of-two global scale


# Share of device memory the resident bf16 ladder may take (6 GB of a
# 15.75 GB device, where the rule was chosen: it left room for the operand
# planes, the c64 factorization and workspace).
_LADDER_MEMORY_SHARE = 0.38


def _slices_fit(A64: SplitComplex, budget_bytes: float | None = None) -> bool:
    """Whether the exact-slicing scheme applies to this operand: the full
    bf16 slice ladder (~24 planes) must fit the slice budget (by default
    ``_LADDER_MEMORY_SHARE`` of device memory), AND every contraction must
    stay exactly accumulable in f32: products ≤ 2^{2w} times a contraction
    length ≤ 2^{24−2w} = 16384 for w = 5 — the bound is on the LONGEST axis
    because the adjoint matvec contracts the other one."""
    if budget_bytes is None:
        budget_bytes = _LADDER_MEMORY_SHARE * backend.device_memory_bytes()
    nelem = A64.re.size
    return 24 * 2 * nelem <= budget_bytes and max(A64.re.shape) <= 16384


def use_sliced_matvecs(A64: SplitComplex) -> bool:
    """Single dispatch rule for every f64-matvec site (refinement, GMRES-IR,
    eig/SVD finishers, the diagnose cond probe): exact-slicing bf16 matvecs
    only where f64 is not native and the ladder fits; native f64 otherwise."""
    return not backend.native_f64() and \
        A64.re.dtype == jnp.float64 and _slices_fit(A64)


def _pow2_ceil(m):
    """Smallest power of two ≥ m, as exact f64, floored at ~2^-99.

    The floor sits inside FLOAT32's exponent range, so the scale stays valid
    (no nan from log2, no zero from exp2) for all-zero inputs even where the
    f64 arithmetic has only float32 range."""
    return jnp.exp2(jnp.ceil(jnp.log2(jnp.maximum(m, 1e-30))))


def _slice_array(P: jax.Array, s: int, w: int, sigma=None):
    """Exact slicing P = sigma · Σ_k slices[k]·2^{−w(k+1)} (+ tail below the
    covered mantissa width). All arithmetic exact: power-of-2 scaling and
    x − round(x) subtractions. ``sigma``: externally supplied power-of-two
    scale (the sharded path computes it with a pmax so all shards share one
    recombination ladder); derived from max|P| when absent."""
    if sigma is None:
        sigma = _pow2_ceil(jnp.max(jnp.abs(P)))
    z = P / sigma
    scale = jnp.asarray(2.0 ** w, P.dtype)
    outs = []
    for _ in range(s):
        zi = jnp.round(z * scale)
        outs.append(zi.astype(jnp.bfloat16))
        z = z * scale - zi
    return jnp.stack(outs), sigma


def extract_ladder(re: jax.Array, im: jax.Array, sigma: jax.Array,
                   mant_bits: int = 53, w: int = 5,
                   f32_tail: bool | None = None):
    """Extract the bf16 integer slice ladders of both planes under a given
    power-of-two scale (shared by :func:`slice_split_matrix` and the
    column-sharded extraction in parallel/dist_refine.py, where ``sigma``
    comes from a cross-shard pmax so every shard slices on one global grid).

    Where f64 is not native its elementwise passes dominate slicing cost, so
    extract 3w = 15 bits per f64 pass (integers ≤ 2^15, exact in f32) and
    split each wide slice into three w-bit bf16 slices with exact f32
    integer arithmetic — 3× fewer f64 passes, identical ladder.

    ``f32_tail``: after TWO wide passes the extracted grid
    covers 30 absolute bits below σ and the remainder satisfies |z| ≤ 0.5 on
    the 2^{−30} grid; casting it to f32 rounds by ≤ 2^{−24}·|z| ≤ 2^{−25},
    i.e. ≤ 2^{−55}·σ absolute — strictly below the ladder's own 2^{−53}·σ
    truncation contract (:func:`slice_split_matrix`) — after which the
    remaining passes are native f32 (exact: power-of-2 scaling, x − round(x)
    cancellation, and integer slices are all f32-representable). Default:
    on only where f64 is not native; off where it is, since the full
    2^{−60} reconstruction exactness is then free.

    Returns ``(slices_re, slices_im)`` stacked (sA, …) bf16."""
    if w != 5:
        raise ValueError("the wide-extraction path assumes w = 5")
    if f32_tail is None:
        f32_tail = not backend.native_f64()
    s = -(-mant_bits // w)
    n_wide = -(-s // 3)

    def extract_wide(z):
        outs = []
        for k in range(n_wide):
            if f32_tail and k == 2 and z.dtype == jnp.float64:
                z = z.astype(jnp.float32)
            big = jnp.asarray(2.0 ** (3 * w), z.dtype)
            zi = jnp.round(z * big)
            outs.append(zi.astype(jnp.float32))
            z = z * big - zi
        return outs

    def split3(S):
        # S integer-valued f32, |S| ≤ 2^15 → three integer slices ≤ 2^5
        t = jnp.round(S * jnp.float32(2.0 ** -10))
        rem = S - t * jnp.float32(2.0 ** 10)
        u = jnp.round(rem * jnp.float32(2.0 ** -5))
        v = rem - u * jnp.float32(2.0 ** 5)
        return (t.astype(jnp.bfloat16), u.astype(jnp.bfloat16),
                v.astype(jnp.bfloat16))

    outs_re, outs_im = [], []
    for wide in extract_wide(re / sigma):
        outs_re.extend(split3(wide))
    for wide in extract_wide(im / sigma):
        outs_im.extend(split3(wide))
    return jnp.stack(outs_re), jnp.stack(outs_im)


def slice_split_matrix(A64: SplitComplex, mant_bits: int = 53,
                       w: int = 5) -> SlicedMatrix:
    """One-time slicing of the split-f64 operand (per refinement call).

    ``mant_bits`` counts ABSOLUTE bits below the joint plane maximum (the
    slicing grid is global, not per-entry): entries far below the max are
    truncated at 2^{−mant_bits}·max|A|, an absolute error that enters the
    residual as ≲ N·2^{−mant_bits}·max|A|·‖x‖ — with the default 53 that is
    below f64 addition roundoff for any N this library targets. (Note a
    complex64-widened operand still needs the full ladder: its entries'
    mantissas sit at their OWN exponents, not the global one.)"""
    # joint power-of-two scale so both planes share one recombination ladder
    sigma = _pow2_ceil(jnp.maximum(jnp.max(jnp.abs(A64.re)),
                                   jnp.max(jnp.abs(A64.im))))
    sl_re, sl_im = extract_ladder(A64.re, A64.im, sigma, mant_bits, w)
    return SlicedMatrix(sl_re, sl_im, sigma)


def _slice_x_cols(x: SplitComplex, sx: int, w: int, sig_re=None, sig_im=None):
    """Slice the x-vector into the shared (N, 2·sx) bf16 column block + its
    per-column f64 recombination scales (one implementation for the dense,
    streamed, and sharded ladders). ``sig_re``/``sig_im``: externally supplied
    power-of-two scales (the sharded path pmax-shares them across shards)."""
    f64 = jnp.float64
    sxr, sig_xr = _slice_array(x.re, sx, w, sigma=sig_re)    # (sx, N) bf16
    sxi, sig_xi = _slice_array(x.im, sx, w, sigma=sig_im)
    X = jnp.concatenate([sxr, sxi], axis=0).T        # (N, 2sx) bf16
    jpow = jnp.exp2(-w * (jnp.arange(sx, dtype=f64) + 1.0))
    colscale = jnp.concatenate([sig_xr * jpow, sig_xi * jpow])   # (2sx,)
    return X, colscale


def _accumulate_ladder(sl_re, sl_im, X, sigma, colscale, acc,
                       w: int = 5, sx: int = 12):
    """Contract one ladder (sA, M, K) against the sliced x block (K, 2·sx)
    and fold the exactly-scaled partials into the four f64 accumulators —
    the ONE slice-GEMM recombination shared by the dense and streamed
    residuals (the distributed path mirrors it per shard)."""
    f64 = jnp.float64
    arxr, arxi, aixr, aixi = acc
    dn = (((1,), (0,)), ((), ()))
    for k in range(sl_re.shape[0]):
        kscale = sigma * (2.0 ** (-w * (k + 1)))
        Yr = jax.lax.dot_general(sl_re[k], X, dn,
                                 preferred_element_type=jnp.float32)
        Yi = jax.lax.dot_general(sl_im[k], X, dn,
                                 preferred_element_type=jnp.float32)
        cr = Yr.astype(f64) * (colscale * kscale)[None, :]
        ci = Yi.astype(f64) * (colscale * kscale)[None, :]
        arxr = arxr + jnp.sum(cr[:, :sx], axis=-1)
        arxi = arxi + jnp.sum(cr[:, sx:], axis=-1)
        aixr = aixr + jnp.sum(ci[:, :sx], axis=-1)
        aixi = aixi + jnp.sum(ci[:, sx:], axis=-1)
    return arxr, arxi, aixr, aixi


def _sliced_residual(sp: SlicedMatrix, x: SplitComplex, b: SplitComplex,
                     w: int = 5, sx: int = 12) -> SplitComplex:
    """r = b − A x via exact bf16 slice GEMMs (see module comment above).

    ``sx = 12`` slices of ``w = 5`` bits cover 60 ≥ 52 mantissa bits, so the
    x-slicing is exact; per A-plane-slice one (N,N)@(N,2·sx) bf16→f32 GEMM.
    Bandwidth: sA passes over bf16 A-slices (half the bytes of one f32 A)."""
    f64 = jnp.float64
    X, colscale = _slice_x_cols(x, sx, w)
    m_rows = sp.sl_re.shape[1]          # output length = operand rows
    z = jnp.zeros((m_rows,), f64)
    arxr, arxi, aixr, aixi = _accumulate_ladder(
        sp.sl_re, sp.sl_im, X, sp.sigma, colscale, (z, z, z, z), w, sx)
    return SplitComplex(b.re - (arxr - aixi), b.im - (arxi + aixr))


def streamed_panels(A64: SplitComplex, budget_bytes: float = 3e9) -> int:
    """Panel count for the STREAMED slice residual at sizes where the full
    ladder no longer fits: only ladder/panels bytes of
    bf16 slices are live at once. Purely memory-driven — panels need NOT
    divide the column count (the last panel is simply narrower; the previous
    smallest-divisor search degenerated to ~N one-column panels for prime or
    2·prime N)."""
    total = 24 * 2 * A64.re.size
    return max(1, -(-total // int(budget_bytes)))


def use_streamed_sliced(A64: SplitComplex) -> bool:
    """Middle dispatch tier between the resident ladder and the plain f64
    GEMVs: f64 not native + f64 planes + contraction still f32-exact per
    panel, but the full ladder exceeds the resident budget. Per-call cost is
    the same GEMM traffic plus a re-extraction of the ladder; the ACCURACY
    is the exact-slicing one."""
    return not backend.native_f64() and \
        A64.re.dtype == jnp.float64 and not _slices_fit(A64) and \
        max(A64.re.shape) <= 16384


def _sliced_residual_streamed(A64: SplitComplex, x: SplitComplex,
                              b: SplitComplex, panels: int, w: int = 5,
                              sx: int = 12, mant_bits: int = 53,
                              sigma=None) -> SplitComplex:
    """r = b − A x at exact-slicing accuracy WITHOUT a resident ladder
    (VERDICT r2 #4): the operand's columns are processed in ``panels``
    chunks under ONE global power-of-two scale — each chunk's bf16 ladder is
    extracted, GEMM'd against the matching x-slice rows, accumulated in f64,
    and freed (the unrolled loop keeps only one panel's slices live). Identical
    f64 result to :func:`_sliced_residual` (same grid, same exact products,
    f64 accumulation reordered by panel). ``sigma``: precomputed global scale
    (refinement hoists it — two full-plane abs-max passes per call
    otherwise; it only depends on A)."""
    f64 = jnp.float64
    m_rows, n = A64.re.shape
    per = -(-n // panels)          # ceil: the last panel may be narrower
    if sigma is None:
        sigma = _pow2_ceil(jnp.maximum(jnp.max(jnp.abs(A64.re)),
                                       jnp.max(jnp.abs(A64.im))))
    X, colscale = _slice_x_cols(x, sx, w)

    z = jnp.zeros((m_rows,), f64)
    acc = (z, z, z, z)
    # statically unrolled — the panel count is memory-driven and small
    # (~O(10)), so program size stays modest and the final panel is free to
    # have its own (narrower) shape: equal panels when panels | n, otherwise
    # a remainder panel (a divisor requirement degenerated for prime N)
    for c0 in range(0, n, per):
        c1 = min(c0 + per, n)
        sl_re, sl_im = extract_ladder(A64.re[:, c0:c1], A64.im[:, c0:c1],
                                      sigma, mant_bits, w)
        acc = _accumulate_ladder(sl_re, sl_im, X[c0:c1], sigma, colscale,
                                 acc, w, sx)
    arxr, arxi, aixr, aixi = acc
    return SplitComplex(b.re - (arxr - aixi), b.im - (arxi + aixr))


def _slice_rows(X: jax.Array, s: int, w: int):
    """Per-row exact slicing of a (K, N) f64 array: (s, K, N) bf16 integer
    slices + per-row power-of-two scales (K,). Same exactness argument as
    :func:`_slice_array`; per-row scales keep candidates with very different
    magnitudes fully resolved."""
    sigma = _pow2_ceil(jnp.max(jnp.abs(X), axis=-1, keepdims=True))   # (K, 1)
    z = X / sigma
    scale = jnp.asarray(2.0 ** w, X.dtype)
    outs = []
    for _ in range(s):
        zi = jnp.round(z * scale)
        outs.append(zi.astype(jnp.bfloat16))
        z = z * scale - zi
    return jnp.stack(outs), sigma[:, 0]


def sliced_matvec_batch(sp: SlicedMatrix, X: SplitComplex,
                        adjoint: bool = False, w: int = 5,
                        sx: int = 12) -> SplitComplex:
    """Batched f64 matvec via exact bf16 slice GEMMs: rows are ``A @ x_k``
    (X: (K, N) against the sliced (M, N) operand), or ``Aᴴ @ x_k``
    (X: (K, M)) when ``adjoint``. Accuracy identical to
    :func:`_sliced_residual` (exact to f64-addition roundoff); cost is the
    same sA bf16 passes over the A slices regardless of K."""
    f64 = jnp.float64
    K = X.re.shape[0]
    sxr, sig_r = _slice_rows(X.re, sx, w)            # (sx, K, N), (K,)
    sxi, sig_i = _slice_rows(X.im, sx, w)
    n_in = X.re.shape[1]
    Xs = jnp.concatenate([sxr.reshape(sx * K, n_in),
                          sxi.reshape(sx * K, n_in)], axis=0)   # (2·sx·K, n)
    jpow = jnp.exp2(-w * (jnp.arange(sx, dtype=f64) + 1.0))     # (sx,)
    # per-block scale for the (2, sx, K) row blocks of Xs
    blk_scale = jnp.stack([jpow[:, None] * sig_r[None, :],
                           jpow[:, None] * sig_i[None, :]])     # (2, sx, K)

    # contraction without materializing a transpose: A @ x contracts A's
    # axis 1; Aᴴ @ x contracts A's axis 0 (and conjugates ⇒ sign flips below)
    dn = (((1,), (1,)), ((), ())) if not adjoint else (((1,), (0,)), ((), ()))
    m_out = sp.sl_re.shape[2] if adjoint else sp.sl_re.shape[1]
    rexr = jnp.zeros((K, m_out), f64)     # Re-plane of A × {xr, xi} results
    rexi = jnp.zeros((K, m_out), f64)
    imxr = jnp.zeros((K, m_out), f64)
    imxi = jnp.zeros((K, m_out), f64)
    sA = sp.sl_re.shape[0]
    for k in range(sA):
        kscale = sp.sigma * (2.0 ** (-w * (k + 1)))
        Yr = jax.lax.dot_general(Xs, sp.sl_re[k], dn,
                                 preferred_element_type=jnp.float32)
        Yi = jax.lax.dot_general(Xs, sp.sl_im[k], dn,
                                 preferred_element_type=jnp.float32)
        cr = (Yr.astype(f64).reshape(2, sx, K, m_out)
              * (blk_scale * kscale)[..., None]).sum(axis=1)    # (2, K, m)
        ci = (Yi.astype(f64).reshape(2, sx, K, m_out)
              * (blk_scale * kscale)[..., None]).sum(axis=1)
        rexr = rexr + cr[0]
        rexi = rexi + cr[1]
        imxr = imxr + ci[0]
        imxi = imxi + ci[1]
    if adjoint:
        # Aᴴ x = (Ar − i·Ai)ᵀ (xr + i·xi)
        return SplitComplex(rexr + imxi, rexi - imxr)
    return SplitComplex(rexr - imxi, rexi + imxr)


def refine(A: jax.Array, fac: LUFactors, b: jax.Array, x0: jax.Array,
           steps: int = 3) -> tuple[jax.Array, jax.Array]:
    """Iteratively refine ``x0`` (solution of the Ψ-shifted proxy system) toward the
    true system ``A x = b`` using f64 residuals and the existing c64 factorization.

    Returns ``(x_in_compute_dtype, rel_residual_f64)``. NOTE: casting back to the
    compute dtype rounds away the refined digits — ``rel`` describes the f64
    iterate, not the returned array. Callers that need the refined precision must
    use :func:`refine_split` and keep the split-f64 representation (the user API
    does; this wrapper exists for in-loop residual steering only).
    """
    xs, rel = refine_split(A, fac, b, x0, steps)
    return xs.to_complex(x0.dtype), rel


@functools.partial(jax.jit, static_argnames=("steps", "a_mant_bits"))
def refine_split(A, fac: LUFactors, b, x0: jax.Array,
                 steps: int = 3, tol: float = 0.0,
                 a_mant_bits: int = 53) -> tuple[SplitComplex, jax.Array]:
    """As :func:`refine` but returns the split-f64 iterate.

    ``A`` / ``b`` may be passed as :class:`SplitComplex` built from the *original*
    full-precision host operands — then refinement targets the user's true system
    (the c64 factorization is only the preconditioner), not its c64 rounding.

    Early-exits (cheap no-op iterations) once the f64 relative residual reaches
    ``tol`` or stops improving; per-step cost is O(N²), so a generous ``steps``
    budget is safe — at large N·ε·κ the contraction per step approaches 1 and
    dozens of steps may be needed (observed at N=4096, κ=1e6).
    """
    A64 = A if isinstance(A, SplitComplex) else SplitComplex.from_complex(A)
    b64 = b if isinstance(b, SplitComplex) else SplitComplex.from_complex(b)
    # when the caller passed the complex array itself, reuse it as the
    # incremental-matvec copy — rebuilding it from the widened planes is two
    # f64 downcast passes plus a second N² array in device memory for a
    # bitwise-equal result
    Ac = A if not isinstance(A, SplitComplex) and \
        jnp.issubdtype(A.dtype, jnp.complexfloating) and \
        A.dtype == x0.dtype else None
    with jax.default_matmul_precision("highest"):
        return _refine_split_impl(A64, fac, b64, x0, steps, tol, a_mant_bits,
                                  Ac=Ac)


def refine_split_c64exact(A: jax.Array, fac: LUFactors, b, x0: jax.Array,
                          steps: int = 3, tol: float = 0.0
                          ) -> tuple[SplitComplex, jax.Array]:
    """:func:`refine_split` for operands whose f64 widening is EXACT (the
    operand is the working-dtype c64 array itself — bench-generated systems,
    user float32/complex64 inputs): the f64 planes are widened from A inside
    the program, and A itself is the incremental-residual matvec copy."""
    return refine_split(A, fac, b, x0, steps=steps, tol=tol)


def make_true_resid(A64: SplitComplex, b64: SplitComplex,
                    a_mant_bits: int = 53):
    """ONE dispatch ladder for the true-f64 residual ``x64 → b − A x``:

    1. resident exact-slicing bf16 ladder (f64 not native, ladder fits);
    2. streamed per-panel ladder (f64 not native, too big to keep resident);
    3. 3M-trick native f64 plane GEMVs (every supported platform).

    Shared by plain IR and GMRES-IR."""
    if use_sliced_matvecs(A64):
        spA = slice_split_matrix(A64, mant_bits=a_mant_bits)
        return lambda x64: _sliced_residual(spA, x64, b64)
    if use_streamed_sliced(A64):
        # ladder too big to keep resident: stream it per column panel —
        # same exact-slicing accuracy, re-extraction per call
        panels = streamed_panels(A64)
        sigma_s = _pow2_ceil(jnp.maximum(jnp.max(jnp.abs(A64.re)),
                                         jnp.max(jnp.abs(A64.im))))
        return lambda x64: _sliced_residual_streamed(
            A64, x64, b64, panels, mant_bits=a_mant_bits, sigma=sigma_s)
    Asum = A64.re + A64.im              # one-time plane sum for the 3M matvec
    return lambda x64: _residual_3m(A64, Asum, x64, b64)


def _refine_split_impl(A64, fac, b64, x0, steps, tol, a_mant_bits=53,
                       true_resid=None, Ac=None):
    # 1e-30 floor: representable in float32 range too (see _pow2_ceil)
    bnorm = jnp.maximum(b64.norm(), jnp.asarray(1e-30, jnp.float64))
    if true_resid is None:
        true_resid = make_true_resid(A64, b64, a_mant_bits)

    # Certified-incremental refinement. The f64 residual reads the operand's
    # f64 planes (3 N² f64 passes), so the inner loop carries the residual
    # INCREMENTALLY in the working dtype — r ← r − A·d costs one c64 GEMV,
    # with relative error ε_f32·κ·‖r‖/‖r‖ ≈ ε·κ per step (< 1 whenever c64 IR can
    # converge at all; it only slows the contraction, never fakes it). Every
    # INNER steps (or on apparent convergence/stall) the outer loop CERTIFIES
    # with a true split-f64 residual and keeps the best certified iterate —
    # the returned ``rel`` is always a true f64 measurement, and a round whose
    # drifted inner estimate lied is simply rejected and iteration stops on
    # the no-improvement guard (caller may then engage GMRES-IR).
    INNER = 8
    if Ac is None:
        Ac = A64.to_complex(x0.dtype)   # fast-matvec copy (exact when A64 was
        #                                 widened from a working-dtype operand)

    def inner_cond(carry):
        _, _, rel, prev_rel, it = carry
        # push past the certify target by 4×: the carried estimate drifts by
        # ~ε·κ per step, and an overshooting step (one c64 solve + GEMV) is
        # cheaper than a failed certification (a full f64 residual round)
        return (it < INNER) & (rel > 0.25 * tol) & (rel <= 0.9 * prev_rel)

    def inner_body(carry):
        x64, r64, rel, _, it = carry
        # correction in working precision against the same factorization
        d = _solve_any(fac, r64.to_complex(x0.dtype))
        d64 = SplitComplex.from_complex(d)
        x_new = SplitComplex(x64.re + d64.re, x64.im + d64.im)
        Ad = Ac @ d
        r_new = SplitComplex(r64.re - Ad.real.astype(r64.re.dtype),
                             r64.im - Ad.imag.astype(r64.im.dtype))
        rel_new = r_new.norm() / bnorm
        # keep the better iterate (and ITS carried residual)
        better = rel_new < rel
        x_out = jax.tree.map(
            lambda new, old: jnp.where(better, new, old), x_new, x64)
        r_out = jax.tree.map(
            lambda new, old: jnp.where(better, new, old), r_new, r64)
        return x_out, r_out, jnp.minimum(rel_new, rel), rel, it + 1

    def outer_cond(carry):
        _, _, rel, prev_rel, total = carry
        return (total < steps) & (rel > tol) & (rel <= 0.9 * prev_rel)

    def outer_body(carry):
        x64, r64, rel_cert, _, total = carry
        xi, _, _, _, it_i = jax.lax.while_loop(
            inner_cond, inner_body,
            (x64, r64, rel_cert, jnp.asarray(jnp.inf, rel_cert.dtype),
             jnp.asarray(0, jnp.int32)))
        # certify: true split-f64 residual of the inner result
        r_true = true_resid(xi)
        rel_true = r_true.norm() / bnorm
        better = rel_true < rel_cert
        x_out = jax.tree.map(
            lambda new, old: jnp.where(better, new, old), xi, x64)
        r_out = jax.tree.map(
            lambda new, old: jnp.where(better, new, old), r_true, r64)
        return (x_out, r_out, jnp.minimum(rel_true, rel_cert), rel_cert,
                total + jnp.maximum(it_i, 1))

    x64 = SplitComplex.from_complex(x0)
    r0 = true_resid(x64)
    rel0 = r0.norm() / bnorm
    x64, _, rel, _, _ = jax.lax.while_loop(
        outer_cond, outer_body,
        (x64, r0, rel0, jnp.asarray(jnp.inf, rel0.dtype),
         jnp.asarray(0, jnp.int32)))
    return x64, rel


def true_residual_norm(A: jax.Array, x: jax.Array, b: jax.Array) -> jax.Array:
    """f64 relative residual ‖Ax−b‖/‖b‖ for c64 operands, batched over leading axes.

    Used by tests and the bench harness as the ground-truth acceptance measure.
    """
    with jax.default_matmul_precision("highest"):
        A64 = SplitComplex.from_complex(A)
        x64 = SplitComplex.from_complex(x)
        b64 = SplitComplex.from_complex(b)
        r = split_residual(A64, x64, b64)
        return r.norm() / jnp.maximum(b64.norm(), 1e-30)


def refine_gmres(A, fac, b, x0: jax.Array, steps: int = 3, tol: float = 0.0,
                 restart: int = 30) -> tuple[SplitComplex, jax.Array]:
    """GMRES-IR: iterative refinement whose correction solve is a *preconditioned
    GMRES* instead of a single factorization solve.

    Plain IR contracts at ~N·ε_f32·κ per step and stalls once that factor nears 1
    (κ ≳ 1e7 at N=4096 in c64). Replacing the single correction solve with
    GMRES on the right-preconditioned operator ``A·P⁻¹`` (P = the c64
    factorization) extends the reachable κ by roughly another 1/ε factor — the
    standard GMRES-IR construction, here with f64 split-plane outer residuals.

    Same contract as :func:`refine_split`.
    """
    from .gmres import gmres_batched

    A64 = A if isinstance(A, SplitComplex) else SplitComplex.from_complex(A)
    b64 = b if isinstance(b, SplitComplex) else SplitComplex.from_complex(b)
    with jax.default_matmul_precision("highest"):
        # jitted with the factors as arguments: executed eagerly, the
        # lax.while_loop would capture fac/A64 as jaxpr constants and embed
        # copies of them in the program
        return _refine_gmres_jit(A64, fac, b64, x0, steps, float(tol),
                                 restart, gmres_batched)


@functools.partial(jax.jit,
                   static_argnames=("steps", "tol", "restart",
                                    "gmres_batched"))
def _refine_gmres_jit(A64, fac, b64, x0, steps, tol, restart, gmres_batched):
    return _refine_gmres_impl(A64, fac, b64, x0, steps, tol, restart,
                              gmres_batched)


def _refine_gmres_impl(A64, fac, b64, x0, steps, tol, restart, gmres_batched):
    # 1e-30 floor: representable in float32 range too (see _pow2_ceil)
    bnorm = jnp.maximum(b64.norm(), jnp.asarray(1e-30, jnp.float64))
    true_resid = make_true_resid(A64, b64)
    Ac = A64.to_complex(x0.dtype)

    def matvec(Z):
        # right-preconditioned operator: A · P⁻¹ (batched over one row)
        y = _solve_any(fac, Z[0])
        return (Ac @ y)[None, :]

    def cond(carry):
        _, _, rel, prev_rel, it = carry
        return (it < steps) & (rel > tol) & (rel <= 0.95 * prev_rel)

    def body(carry):
        x64, r64, rel, _, it = carry
        r = r64.to_complex(x0.dtype)
        res = gmres_batched(matvec, r[None, :], tol=1e-6, restart=restart,
                            max_restarts=2)
        d = _solve_any(fac, res.x[0])          # un-precondition: x = P⁻¹ y
        d64 = SplitComplex.from_complex(d)
        x_new = SplitComplex(x64.re + d64.re, x64.im + d64.im)
        r_new = true_resid(x_new)
        rel_new = r_new.norm() / bnorm
        better = rel_new < rel
        x_out = jax.tree.map(lambda new, old: jnp.where(better, new, old),
                             x_new, x64)
        r_out = jax.tree.map(lambda new, old: jnp.where(better, new, old),
                             r_new, r64)
        # where, not minimum: a NaN rel_new from a broken-down GMRES round
        # must not poison the carried (certified) rel — the iterate itself is
        # already guarded by ``better``
        return x_out, r_out, jnp.where(better, rel_new, rel), rel, it + 1

    x64 = SplitComplex.from_complex(x0)
    r0 = true_resid(x64)
    rel0 = r0.norm() / bnorm
    x64, _, rel, _, _ = jax.lax.while_loop(
        cond, body, (x64, r0, rel0, jnp.asarray(jnp.inf, rel0.dtype),
                     jnp.asarray(0, jnp.int32)))
    return x64, rel
