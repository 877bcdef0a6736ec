"""Distributed mixed-precision finishers for eigenpairs and singular triplets
(VERDICT r2 #2).

The single-chip finishers (:mod:`maus_tpu.ops.refine_eig`) close the c64→tol
gap with split-f64 Newton steps whose correction solves are batched c64 LUs of
full N×N operators — K·N² memory that cannot exist on an operand that only
fits sharded. These are the mesh-scalable counterparts:

* **Eigenpairs** — identical Newton algebra (bordered elimination,
  δv = δλ·H⁻¹v − H⁻¹r), but the correction solves go through the
  COLUMN-SHARDED Hessenberg form the distributed engine already built
  (:func:`maus_tpu.parallel.dist_hessenberg.dist_solve_shifted`) — O(K·N²/m)
  per solve, no new factorization, no O(N²) replication.
* **Singular triplets** — the same augmented-operator Newton step as
  ``refine_svd_triplets``, but the Gram system ``(AᴴA − σ²I + ψ) dv = rhs`` is
  solved by a **projected, Jacobi-preconditioned GMRES** whose matvec is two
  sharded GEMMs (z ↦ Aᴴ(Az)) instead of a K-batch of N×N LUs. Projection onto
  v's complement is the Jacobi–Davidson correction-equation trick: the
  operator is nearly singular *along v* by construction and well-conditioned
  (≈ σ₁²/gap) on the complement, which is exactly where the Newton correction
  lives. Inexact inner solves still contract the outer Newton iteration
  (inexact-Newton); the per-candidate forcing tolerance follows the
  Eisenstat–Walker choice-2 schedule (tight inner solves only once the outer
  iteration is contracting fast — clustered σ spectra no longer pay extra
  outer steps against a fixed loose tolerance), and a keep-best guard makes a
  failed step a no-op.

f64 residuals are split-plane GEMMs against the column-sharded original
operand — GSPMD inserts the psums (the sharded exact-slicing variant can be
swapped in via the ``matvec``/``matvec_adj`` seams).

Reference parity: AMS:25/341 tolerance contract, residuals per M4g
(AMS:297/301) — the reference gets f64 for free on CPU; this is what makes its
tolerances reachable on mesh-sharded c64 operands.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import backend
from ..ops.refine import SplitComplex, scaled_fro
from ..ops.refine_eig import (_from_c, _sdiv, _sdot, _smatvec, _smatvec_adj,
                              _snorm, _to_c)
from .dist_hessenberg import DistHess, dist_solve_shifted
from .mesh import MODEL_AXIS

_EPS32 = float(jnp.finfo(jnp.float32).eps)


def stage_spectral(mesh: Mesh, A, dtype=None):
    """Stage an eig/SVD operand for the distributed engine + finishers:
    column-sharded compute copy plus column-sharded split-f64 planes of the
    ORIGINAL data (refinement must target the user's operand, not its c64
    rounding). Accepts host arrays or already-device/sharded arrays.

    ``dtype=None`` picks ``backend.default_complex_dtype()``;
    tests pass an explicit c64 to exercise the genuine mixed-precision path
    on the CPU mesh. Returns ``(A_dev, SplitComplex(Are, Aim))``.
    """
    import numpy as np

    rdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if dtype is None:
        dtype = backend.default_complex_dtype()
    col_shard = NamedSharding(mesh, P(None, MODEL_AXIS))
    if not hasattr(A, "sharding"):
        # host operand: every piece goes straight to its column shards, so
        # no full-size copy is ever placed on one device
        A_host = np.asarray(A)
        Are = jax.device_put(A_host.real.astype(rdt), col_shard)
        Aim = jax.device_put(A_host.imag.astype(rdt), col_shard)
        A_dev = jax.device_put(A_host.astype(dtype), col_shard)
    else:
        # already-on-device operand: one jitted program derives the pieces
        Are, Aim, A_dev = jax.jit(
            lambda a: (a.real.astype(rdt), a.imag.astype(rdt),
                       a.astype(dtype)),
            out_shardings=(col_shard, col_shard, col_shard))(A)
    return A_dev, SplitComplex(Are, Aim)


# ---------------------------------------------------------------------------
# Eigenpair refinement against the sharded Hessenberg form
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mesh", "steps"))
def dist_refine_eigenpairs(mesh: Mesh, hess: DistHess, A64: SplitComplex,
                           lam0: jax.Array, V0: jax.Array, steps: int = 5,
                           psi_rel: float = 3e-6):
    """Refine K eigenpair candidates to f64-limited residuals, mesh-sharded.

    Same Newton iteration as :func:`maus_tpu.ops.refine_eig.refine_eigenpairs`
    (cited there: F(v,λ) Newton with bordered elimination), with the batched
    c64 LU replaced by shifted solves against the column-sharded Hessenberg
    form. The shift refactors at the current Rayleigh quotient EVERY step
    (free here — the sweep takes shifts as data) with per-step ψ continuation,
    and the iterate advances through finite-but-worse steps with best-so-far
    returned (see the body comment). Returns ``(lam Split (K,), V Split
    (K,N), resid (K,) f64)`` with ‖v‖=1, resid = ‖Av − λv‖ in f64 vs the
    sharded planes.
    """
    cdtype = V0.dtype
    rdt = A64.re.dtype
    K, N = V0.shape
    with jax.default_matmul_precision("highest"):
        scale, s2 = scaled_fro(A64.re, A64.im)
        anorm = (scale * jnp.sqrt(s2 / N)).astype(rdt)
        psi = (psi_rel * anorm).astype(jnp.float32)

        smv = lambda X: _smatvec(A64, X)      # GSPMD shards the plane GEMMs

        V = _from_c(V0, rdt)
        nrm = jnp.maximum(_snorm(V), 1e-30)
        V = SplitComplex(V.re / nrm[:, None], V.im / nrm[:, None])

        def rayleigh_resid(V):
            W = smv(V)                                    # A v (f64)
            lam = _sdiv(_sdot(V, W), _sdot(V, V))         # f64 Rayleigh
            r = SplitComplex(W.re - (lam.re[:, None] * V.re
                                     - lam.im[:, None] * V.im),
                             W.im - (lam.re[:, None] * V.im
                                     + lam.im[:, None] * V.re))
            return lam, r, _snorm(r)

        # The Hessenberg sweep takes its shifts as DATA (one Givens pass per
        # solve either way), so unlike the single-chip LU/QR transports the
        # shift refactors EVERY step for free — classic RQI — and the ψ
        # continuation (see refine_eigenpairs.one_round: a fixed ψ is an
        # O(ψ·non-normality) inexact-Newton stall on non-normal operands)
        # rides along per step, tied to the candidate's current residual.
        # The iterate ADVANCES through finite-but-worse steps (an in-place
        # rejection is an absorbing state — see ops.refine_eig
        # ._bordered_newton); best-so-far is tracked separately and returned.
        def body(_, carry):
            V, lam_sh, psi_k, bV, blam, brn = carry
            lam_new, r, rn = rayleigh_resid(V)
            cur_better = jnp.isfinite(rn) & (rn < brn)
            bV = SplitComplex(jnp.where(cur_better[:, None], V.re, bV.re),
                              jnp.where(cur_better[:, None], V.im, bV.im))
            blam = SplitComplex(jnp.where(cur_better, lam_new.re, blam.re),
                                jnp.where(cur_better, lam_new.im, blam.im))
            brn = jnp.where(cur_better, rn, brn)

            def solve(B):
                return dist_solve_shifted(mesh, hess, lam_sh, B, psi_k)

            u1 = solve(_to_c(V, cdtype))                  # H⁻¹ v
            u2 = solve(_to_c(r, cdtype))                  # H⁻¹ r
            num = jnp.sum(jnp.conj(_to_c(V, cdtype)) * u2, axis=-1)
            den = jnp.sum(jnp.conj(_to_c(V, cdtype)) * u1, axis=-1)
            den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
            dlam = num / den
            dv = dlam[:, None] * u1 - u2                  # δv = δλ H⁻¹v − H⁻¹r
            dv64 = _from_c(dv, rdt)
            V_new = SplitComplex(V.re + dv64.re, V.im + dv64.im)
            nn = jnp.maximum(_snorm(V_new), 1e-30)
            V_new = SplitComplex(V_new.re / nn[:, None], V_new.im / nn[:, None])
            ok = jnp.all(jnp.isfinite(V_new.re), axis=-1) \
                & jnp.all(jnp.isfinite(V_new.im), axis=-1)
            Vo = SplitComplex(jnp.where(ok[:, None], V_new.re, V.re),
                              jnp.where(ok[:, None], V_new.im, V.im))
            # Refactor the shift at the current Rayleigh quotient while the
            # residual is ABOVE the c64 rounding cloud, then FREEZE: chasing
            # λ below ~100·ε_f32·‖A‖ puts σ_min(H) inside H's own c64
            # rounding error and the near-exactly-singular solves degrade the
            # bordered cancellation (measured on the 64² CPU-mesh tier:
            # always-refactor left 3/16 pairs at 1.2-3.3e-9 vs the 1e-11·‖A‖_F
            # bar; a frozen ~1e-5-distant shift still contracts ≥1e4×/step).
            # A non-finite step keeps shift and ψ unchanged either way.
            refactor = ok & (rn > 100.0 * _EPS32 * anorm).astype(bool)
            lam_c = jax.lax.complex(lam_new.re.astype(jnp.float32),
                                    lam_new.im.astype(jnp.float32)
                                    ).astype(cdtype)
            lam_sh = jnp.where(refactor, lam_c, lam_sh)
            r32 = rn.astype(jnp.float32)
            psi_new = jnp.where(jnp.isfinite(r32),
                                jnp.minimum(psi, 1e-4 * r32), psi)
            psi_k = jnp.where(refactor, psi_new, psi_k)
            return Vo, lam_sh, psi_k, bV, blam, brn

        lam_init = SplitComplex(lam0.real.astype(rdt), lam0.imag.astype(rdt))
        brn0 = jnp.full((K,), jnp.inf, rdt)
        psi_k0 = jnp.broadcast_to(psi, (K,))
        V_last, _, _, bV, blam, brn = jax.lax.fori_loop(
            0, steps, body, (V, lam0, psi_k0, V, lam_init, brn0))
        lam_f, _, rn_f = rayleigh_resid(V_last)   # score the final iterate
        fin_better = jnp.isfinite(rn_f) & (rn_f < brn)
        bV = SplitComplex(jnp.where(fin_better[:, None], V_last.re, bV.re),
                          jnp.where(fin_better[:, None], V_last.im, bV.im))
        blam = SplitComplex(jnp.where(fin_better, lam_f.re, blam.re),
                            jnp.where(fin_better, lam_f.im, blam.im))
        brn = jnp.where(fin_better, rn_f, brn)
        return blam, bV, brn


# ---------------------------------------------------------------------------
# Singular-triplet refinement via projected GMRES correction solves
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mesh", "steps", "inner_restart"))
def dist_refine_svd(mesh: Mesh, A_dev: jax.Array, A64: SplitComplex,
                    sig0: jax.Array, U0: jax.Array, V0: jax.Array,
                    steps: int = 5, psi_rel: float = 3e-6,
                    inner_restart: int = 24):
    """Refine K singular-triplet candidates to f64-limited residuals without
    any N×N factorization (mesh-scalable SVD finisher).

    Newton on the augmented Hermitian [[0, A], [Aᴴ, 0]] eigenpair (σ, [u;v]),
    block-eliminated to ``(AᴴA − σ²I + ψ) dv = −(σ r₂ + Aᴴ r₁)`` exactly as
    :func:`maus_tpu.ops.refine_eig.refine_svd_triplets`, with the batched
    Gram LU replaced by a projected Jacobi-preconditioned GMRES whose matvec
    is two sharded GEMMs. σ≈0 (null-vector) triplets pass through unchanged.

    Returns ``(sigma (K,) f64, U Split (K,M), V Split (K,N), resid (K,) f64)``
    with resid = ‖Av − σu‖ + ‖Aᴴu − σv‖ (two-sided, AMS:301).
    """
    from ..ops.gmres import gmres_batched, jacobi_from_diag

    cdtype = V0.dtype
    rdt = A64.re.dtype
    K, N = V0.shape
    with jax.default_matmul_precision("highest"):
        scale, s2 = scaled_fro(A64.re, A64.im)
        anorm = (scale * jnp.sqrt(s2 / min(A64.re.shape))).astype(rdt)
        psi = (psi_rel * anorm * anorm).astype(jnp.float32)   # Gram scale ‖A‖²
        smv = lambda X: _smatvec(A64, X)
        smva = lambda X: _smatvec_adj(A64, X)
        sig_f = sig0.real.astype(jnp.float32)
        small = sig_f < 1e-6 * jnp.maximum(anorm.astype(jnp.float32), 1e-30)

        # Jacobi diagonal of the Gram operator: column norms of A (sharded
        # reduction, GSPMD; scaled — the naive per-column sum of squares
        # overflows f32-range for entries ~1e19) — (N,) real
        _, col_s = scaled_fro(A64.re, A64.im, axis=0)
        coldiag = ((scale * scale) * col_s).astype(jnp.float32)

        U = _from_c(U0, rdt)
        V = _from_c(V0, rdt)
        un = jnp.maximum(_snorm(U), 1e-30)
        vn = jnp.maximum(_snorm(V), 1e-30)
        U = SplitComplex(U.re / un[:, None], U.im / un[:, None])
        V = SplitComplex(V.re / vn[:, None], V.im / vn[:, None])
        sig = sig0.real.astype(rdt)

        def resid_of(sig, U, V, Av=None):
            # ``Av``: caller-provided A·V (the Newton body already computed it
            # for the σ update — recomputing cost ~25% of the step's split-f64
            # GEMM work)
            if Av is None:
                Av = smv(V)
            Ahu = smva(U)
            r1 = SplitComplex(Av.re - sig[:, None] * U.re,
                              Av.im - sig[:, None] * U.im)
            r2 = SplitComplex(Ahu.re - sig[:, None] * V.re,
                              Ahu.im - sig[:, None] * V.im)
            return r1, r2, _snorm(r1) + _snorm(r2)

        def gram_solve(rhs_c, sig_new, Vc, eta):
            """Projected inexact solve of (AᴴA − σ² + ψ) t = rhs, t ⊥ v, to a
            per-candidate forcing tolerance ``eta`` (Eisenstat–Walker)."""
            shift = (sig_new.astype(jnp.float32) ** 2).astype(jnp.float32)

            def cproj(X):
                c = jnp.sum(jnp.conj(Vc) * X, axis=-1, keepdims=True)
                return X - c * Vc

            def matvec(Z):
                Zp = cproj(Z)
                AZ = jnp.matmul(Zp, A_dev.T,
                                precision=jax.lax.Precision.HIGHEST)
                G = jnp.matmul(AZ, jnp.conj(A_dev),
                               precision=jax.lax.Precision.HIGHEST)
                return cproj(G - (shift - psi)[:, None].astype(G.real.dtype)
                             * Zp)

            diag = (coldiag[None, :] - shift[:, None] + psi).astype(cdtype)
            res = gmres_batched(matvec, cproj(rhs_c),
                                x0=jnp.zeros_like(rhs_c),
                                precond_diag=jacobi_from_diag(diag),
                                tol=eta, restart=inner_restart,
                                max_restarts=2)
            return cproj(res.x)

        def body(_, carry):
            sig, U, V, rbest, eta = carry
            Av = smv(V)
            sig_new = _sdot(U, Av).re                     # f64 σ update
            r1, r2, rn = resid_of(sig_new, U, V, Av=Av)
            Ahr1 = smva(r1)
            rhs = SplitComplex(-(sig_new[:, None] * r2.re + Ahr1.re),
                               -(sig_new[:, None] * r2.im + Ahr1.im))
            dv = gram_solve(_to_c(rhs, cdtype), sig_new, _to_c(V, cdtype),
                            eta)
            dv64 = _from_c(dv, rdt)
            Adv = smv(dv64)
            sig_safe = jnp.where(small, 1.0, sig_new)[:, None]
            du = SplitComplex((Adv.re + r1.re) / sig_safe,
                              (Adv.im + r1.im) / sig_safe)
            V_new = SplitComplex(V.re + dv64.re, V.im + dv64.im)
            U_new = SplitComplex(U.re + du.re, U.im + du.im)
            nn = jnp.maximum(_snorm(V_new), 1e-30)
            V_new = SplitComplex(V_new.re / nn[:, None], V_new.im / nn[:, None])
            nn = jnp.maximum(_snorm(U_new), 1e-30)
            U_new = SplitComplex(U_new.re / nn[:, None], U_new.im / nn[:, None])
            Av2 = smv(V_new)
            sig2 = _sdot(U_new, Av2).re
            _, _, rn2 = resid_of(sig2, U_new, V_new, Av=Av2)
            better = (rn2 < rn) & ~small
            Uo = SplitComplex(jnp.where(better[:, None], U_new.re, U.re),
                              jnp.where(better[:, None], U_new.im, U.im))
            Vo = SplitComplex(jnp.where(better[:, None], V_new.re, V.re),
                              jnp.where(better[:, None], V_new.im, V.im))
            so = jnp.where(better, sig2, jnp.where(small, sig, sig_new))
            # Eisenstat–Walker choice-2 forcing for the NEXT outer step:
            # η ← γ(‖F_new‖/‖F_old‖)², safeguarded against premature tightening
            # by γη² when that still exceeds 0.1, clamped to [1e-4, 0.5]. Fast
            # outer contraction → tighter inner solves exactly when a Newton
            # step can use them; a rejected step (ratio ≈ 1) relaxes η instead
            # of burning inner iterations (STATUS r3 gap 5).
            # residual OF THE RETURNED STATE (code-review r3, confirmed on
            # the CPU mesh): ``better`` states certify rn2, rejected steps
            # certify rn (evaluated exactly at the returned sig_new/U/V), and
            # σ≈0 pass-through candidates keep their ENTRY residual — the old
            # min over rn/rn2 folded in residuals of states never returned
            # (measured: reported 1.044 vs actual 1.273) and let a NaN rn2
            # poison the report. The sequence is monotone by construction
            # (rejected steps leave U/V unchanged, accepted ones have
            # rn2 < rn), so no running min is needed.
            step_resid = jnp.where(better, rn2, rn)
            resid_out = jnp.where(small, rbest, step_resid)
            # NaN-safe Eisenstat–Walker ratio: a rejected step contributes
            # ratio = 1 (relax η), never a NaN from a blown-up trial state
            ratio = (step_resid
                     / jnp.maximum(rn, 1e-30)).astype(jnp.float32)
            eta_raw = 0.9 * ratio * ratio
            guard = 0.9 * eta * eta
            eta_new = jnp.where(guard > 0.1, jnp.maximum(eta_raw, guard),
                                eta_raw)
            eta_new = jnp.clip(eta_new, 1e-4, 0.5)
            return so, Uo, Vo, resid_out, eta_new

        _, _, rn0 = resid_of(sig, U, V)
        eta0 = jnp.full((K,), 1e-2, jnp.float32)
        sig, U, V, resid, _ = jax.lax.fori_loop(0, steps, body,
                                                (sig, U, V, rn0, eta0))
        return sig, U, V, resid


# ---------------------------------------------------------------------------
# Column-sharded exact-slicing f64 residual (VERDICT r2 #3)
# ---------------------------------------------------------------------------
#
# For a backend without native f64 (see ops/refine.py's exact-slicing
# section; no supported platform takes this path). Each device slices ITS
# OWN column shard of the split-f64 planes into the bf16 integer ladder
# (ops.refine.extract_ladder) under a pmax-shared global power-of-two scale,
# runs the exact bf16 slice GEMMs against its local x-slice segment, and the
# f64 partial sums reassemble with ONE psum of four (N,) f64 vectors per
# residual — identical f64 result to the dense _sliced_residual, exactness
# argument unchanged (partial contractions of exact ≤2^{2w} integer products
# stay below the 2^24 f32-exact bound whenever the full contraction does).

def dist_slice_operand(mesh: Mesh, A64: SplitComplex):
    """Per-shard bf16 slice ladders + the shared global scale.

    Returns ``(sl_re, sl_im, sigma)`` with the slice stacks sharded
    P(None, None, model) — per-device ladder memory is 1/m of the dense
    ladder, which lifts the single-device _slices_fit cap by the mesh factor.
    """
    from ..ops.refine import _pow2_ceil, extract_ladder

    def local(re_loc, im_loc):
        m_loc = jnp.maximum(jnp.max(jnp.abs(re_loc)),
                            jnp.max(jnp.abs(im_loc)))
        sigma = _pow2_ceil(jax.lax.pmax(m_loc, MODEL_AXIS))
        sl_re, sl_im = extract_ladder(re_loc, im_loc, sigma)
        return sl_re, sl_im, sigma

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, MODEL_AXIS), P(None, MODEL_AXIS)),
        out_specs=(P(None, None, MODEL_AXIS), P(None, None, MODEL_AXIS),
                   P()))(A64.re, A64.im)


def dist_sliced_residual(mesh: Mesh, sl_re: jax.Array, sl_im: jax.Array,
                         sigma: jax.Array, x: SplitComplex, b: SplitComplex,
                         w: int = 5, sx: int = 12) -> SplitComplex:
    """r = b − A x with A column-sharded as bf16 slice ladders; x, b
    replicated (N,) split-f64. One psum of four (N,) f64 partials."""
    from ..ops.refine import _accumulate_ladder, _pow2_ceil, _slice_x_cols

    n = x.re.shape[0]
    m = mesh.shape[MODEL_AXIS]
    c = n // m
    f64 = x.re.dtype

    def local(slr, sli, sig, xre, xim, bre, bim):
        me = jax.lax.axis_index(MODEL_AXIS)
        xre_loc = jax.lax.dynamic_slice(xre, (me * c,), (c,))
        xim_loc = jax.lax.dynamic_slice(xim, (me * c,), (c,))
        # global power-of-two x scales (pmax) so the recombination ladder is
        # shard-independent; slicing the LOCAL segment under the global scale
        # is exact (power-of-2 scaling + round-to-int subtraction)
        sig_xr = _pow2_ceil(jax.lax.pmax(jnp.max(jnp.abs(xre_loc)),
                                         MODEL_AXIS))
        sig_xi = _pow2_ceil(jax.lax.pmax(jnp.max(jnp.abs(xim_loc)),
                                         MODEL_AXIS))
        # the shared slice-x + ladder-recombination helpers (ops.refine) —
        # this path previously carried a fourth drifting copy of the k-loop
        X, colscale = _slice_x_cols(SplitComplex(xre_loc, xim_loc), sx, w,
                                    sig_re=sig_xr, sig_im=sig_xi)
        z = jnp.zeros((n,), f64)
        arxr, arxi, aixr, aixi = _accumulate_ladder(
            slr, sli, X, sig, colscale, (z, z, z, z), w, sx)
        parts = jax.lax.psum(jnp.stack([arxr, arxi, aixr, aixi]), MODEL_AXIS)
        return bre - (parts[0] - parts[3]), bim - (parts[1] + parts[2])

    rre, rim = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None, MODEL_AXIS), P(None, None, MODEL_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=(P(), P()))(sl_re, sl_im, sigma, x.re, x.im, b.re, b.im)
    return SplitComplex(rre, rim)
