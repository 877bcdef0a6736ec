"""Mixed-precision finishers for eigenpairs and singular triplets.

The linear path reaches the user's 1e-8 tolerance via split-f64 iterative
refinement (:mod:`maus_tpu.ops.refine`). This module closes the same gap for
the other two problem classes: with c64 compute the evolve loop accepts
eig/SVD candidates at the c64 floor ≈ √N·ε_f32; these finishers take those
candidates to f64-limited accuracy with O(N²) work per step.

Eigenpairs — Newton iteration on F(v, λ) = (Av − λv, vᴴv − 1):

    [A − λI   −v] [δv]   [−r]
    [  vᴴ      0] [δλ] = [ 0]

solved by bordered elimination against ONE batched c64 LU of
H_k = A − λ_k I + ψI per candidate (δv = δλ·H⁻¹v − H⁻¹r). H is nearly singular
*along v* by construction, but the Newton correction lives in v's complement,
where H's effective conditioning is ‖A‖/gap — so the c64 solves are accurate
exactly where it matters, and the f64 split-plane residuals drive quadratic-ish
convergence to ~ε_f64·κ levels. Residual evaluation is always against the
ORIGINAL full-precision operand (reference M4g semantics, AMS:297).

Singular triplets — the same Newton step on the augmented Hermitian operator
[[0, A], [Aᴴ, 0]] with eigenpair (σ, [u; v]/√2), block-eliminated so the only
factorization is the N×N Gram system G_k = AᴴA − σ_k²I + ψI per candidate.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsla

from ..core import backend
from .refine import (SplitComplex, scaled_fro, slice_split_matrix,
                     sliced_matvec_batch)


def _percand_shifted_solver(build_H, shifts, n: int):
    """Factor one (N, N) shifted system per candidate and return a batched
    ``solve(B: (K, N)) -> (K, N)`` closure.

    Three regimes; the last two exist only for a backend with a branch
    memory cap (``backend.branch_memory_cap()``, False on every supported
    platform), whose compiler refuses the batched complex LU past N = 2048
    and the unbatched one past N = 4096:

    1. **vmap LU**: the fast batched path.
    2. **lax.map LU** (capped backend, N ≤ 4096): one candidate at a time —
       identical O(K·N³) flops, only the factorization loses
       cross-candidate parallelism.
    3. **lax.map QR** (capped backend, N > 4096): QR has no pivot panel, so
       H = QR per candidate (2× LU flops, 2× factor storage;
       ``MausSolver._refine_chunk`` halves the chunk accordingly).

    The Newton loop's repeated solves stay vmap-batched in every regime."""
    if not backend.branch_memory_cap() or n <= 2048:
        lu, piv = jax.vmap(lambda s: jsla.lu_factor(build_H(s)))(shifts)
        return lambda B: jax.vmap(
            lambda l, p, b: jsla.lu_solve((l, p), b))(lu, piv, B)
    if n <= 4096:
        lu, piv = jax.lax.map(lambda s: jsla.lu_factor(build_H(s)), shifts)
        return lambda B: jax.vmap(
            lambda l, p, b: jsla.lu_solve((l, p), b))(lu, piv, B)
    q, r = jax.lax.map(lambda s: jnp.linalg.qr(build_H(s)), shifts)

    def solve(B):
        def one(qk, rk, bk):
            y = jnp.conj(qk.T) @ bk
            return jax.lax.linalg.triangular_solve(
                rk, y[:, None], lower=False, left_side=True)[:, 0]
        return jax.vmap(one)(q, r, B)
    return solve


# ---------------------------------------------------------------------------
# split-complex helpers (batched rows: X is (K, N), A is (M, N) split planes)
# ---------------------------------------------------------------------------

def _smatvec(A: SplitComplex, X: SplitComplex) -> SplitComplex:
    """Rows of the result are A @ x_k (X: (K, N) against A: (M, N))."""
    return SplitComplex(X.re @ A.re.T - X.im @ A.im.T,
                        X.re @ A.im.T + X.im @ A.re.T)


def _smatvec_adj(A: SplitComplex, X: SplitComplex) -> SplitComplex:
    """Rows of the result are Aᴴ @ x_k (X: (K, M) against A: (M, N))."""
    return SplitComplex(X.re @ A.re + X.im @ A.im,
                        X.im @ A.re - X.re @ A.im)


def _matvec_fns(A64: SplitComplex):
    """(A·x, Aᴴ·x) batched-row f64 matvecs: native-f64 GEMMs, or the
    exact-slicing bf16 GEMMs where f64 is not native (refine.SlicedMatrix)."""
    from .refine import use_sliced_matvecs

    if not use_sliced_matvecs(A64):
        return (lambda X: _smatvec(A64, X)), (lambda X: _smatvec_adj(A64, X))
    sp = slice_split_matrix(A64)
    return (lambda X: sliced_matvec_batch(sp, X),
            lambda X: sliced_matvec_batch(sp, X, adjoint=True))


def _sdot(a: SplitComplex, b: SplitComplex) -> SplitComplex:
    """⟨a, b⟩ = Σ conj(a)·b along the last axis (batched)."""
    return SplitComplex(jnp.sum(a.re * b.re + a.im * b.im, axis=-1),
                        jnp.sum(a.re * b.im - a.im * b.re, axis=-1))


def _sdiv(x: SplitComplex, y: SplitComplex) -> SplitComplex:
    den = jnp.maximum(y.re * y.re + y.im * y.im, 1e-30)
    return SplitComplex((x.re * y.re + x.im * y.im) / den,
                        (x.im * y.re - x.re * y.im) / den)


def _smul(x: SplitComplex, y: SplitComplex) -> SplitComplex:
    return SplitComplex(x.re * y.re - x.im * y.im,
                        x.re * y.im + x.im * y.re)


def _snorm(x: SplitComplex) -> jax.Array:
    return jnp.sqrt(jnp.sum(x.re * x.re + x.im * x.im, axis=-1))


def _to_c(x: SplitComplex, dtype) -> jax.Array:
    rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
    return jax.lax.complex(x.re.astype(rdt), x.im.astype(rdt)).astype(dtype)


def _from_c(z: jax.Array, rdt) -> SplitComplex:
    return SplitComplex(z.real.astype(rdt), z.imag.astype(rdt))


# ---------------------------------------------------------------------------
# Eigenpair refinement
# ---------------------------------------------------------------------------

def _bordered_newton(smv, solve, V: SplitComplex, lam_init: SplitComplex,
                     steps: int, cdtype):
    """``steps`` bordered-Newton iterations, returning the per-candidate BEST
    observed state (by f64 residual), not the last iterate.

    ``solve(B: (K, N) cdtype) -> (K, N)`` applies the per-candidate shifted
    inverses (a direct factorization solve against H_k = A − (λ_k − ψ_k)I).
    Returns ``(V, lam, resid)``.

    The iterate ADVANCES through a finite-but-worse step: an earlier version
    rejected such steps in place, which makes any one-step rise an absorbing
    state at a fixed factorization (the rejected step recomputes identically
    forever — measured on the N=4096 Ginibre stragglers, whose first step
    from the stuck state rises 6.06e-5 → 6.93e-5 and then falls 3.3e-6 →
    8.7e-8 → 2e-9 → 4e-11 if allowed to proceed). Only a non-finite step
    (true blow-up on defective/near-singular shifts) keeps the old iterate;
    best-keeping guarantees the RETURNED state never regresses either way."""
    rdt = V.re.dtype
    K = V.re.shape[0]

    def rayleigh_resid(V):
        W = smv(V)                                # A v (f64)
        lam = _sdiv(_sdot(V, W), _sdot(V, V))     # f64 Rayleigh
        r = SplitComplex(W.re - (lam.re[:, None] * V.re
                                 - lam.im[:, None] * V.im),
                         W.im - (lam.re[:, None] * V.im
                                 + lam.im[:, None] * V.re))
        return lam, r, _snorm(r)

    def body(_, carry):
        V, bV, blam, brn = carry
        lam_new, r, rn = rayleigh_resid(V)
        # fold the CURRENT state into best-so-far (covers the incoming state
        # on the first iteration and the final advanced state implicitly —
        # each iterate is scored before the next step is taken)
        cur_better = jnp.isfinite(rn) & (rn < brn)
        bV = SplitComplex(jnp.where(cur_better[:, None], V.re, bV.re),
                          jnp.where(cur_better[:, None], V.im, bV.im))
        blam = SplitComplex(jnp.where(cur_better, lam_new.re, blam.re),
                            jnp.where(cur_better, lam_new.im, blam.im))
        brn = jnp.where(cur_better, rn, brn)
        u1 = solve(_to_c(V, cdtype))              # H⁻¹ v
        u2 = solve(_to_c(r, cdtype))              # H⁻¹ r
        num = jnp.sum(jnp.conj(_to_c(V, cdtype)) * u2, axis=-1)
        den = jnp.sum(jnp.conj(_to_c(V, cdtype)) * u1, axis=-1)
        den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
        dlam = num / den
        dv = dlam[:, None] * u1 - u2              # δλ H⁻¹v − H⁻¹r
        dv64 = _from_c(dv, rdt)
        V_new = SplitComplex(V.re + dv64.re, V.im + dv64.im)
        nn = jnp.maximum(_snorm(V_new), 1e-30)
        V_new = SplitComplex(V_new.re / nn[:, None],
                             V_new.im / nn[:, None])
        ok = jnp.all(jnp.isfinite(V_new.re), axis=-1) \
            & jnp.all(jnp.isfinite(V_new.im), axis=-1)
        Vo = SplitComplex(jnp.where(ok[:, None], V_new.re, V.re),
                          jnp.where(ok[:, None], V_new.im, V.im))
        return Vo, bV, blam, brn

    brn0 = jnp.full((K,), jnp.inf, rdt)
    V_last, bV, blam, brn = jax.lax.fori_loop(
        0, steps, body, (V, V, lam_init, brn0))
    # score the final advanced iterate too (the loop scores pre-step states)
    lam_f, _, rn_f = rayleigh_resid(V_last)
    fin_better = jnp.isfinite(rn_f) & (rn_f < brn)
    bV = SplitComplex(jnp.where(fin_better[:, None], V_last.re, bV.re),
                      jnp.where(fin_better[:, None], V_last.im, bV.im))
    blam = SplitComplex(jnp.where(fin_better, lam_f.re, blam.re),
                        jnp.where(fin_better, lam_f.im, blam.im))
    brn = jnp.where(fin_better, rn_f, brn)
    return bV, blam, brn


@functools.partial(jax.jit, static_argnames=("steps", "rounds"))
def refine_eigenpairs(A64: SplitComplex, lam0: jax.Array, V0: jax.Array,
                      steps: int = 4, psi_rel: float = 3e-6,
                      rounds: int = 2
                      ) -> tuple[SplitComplex, SplitComplex, jax.Array]:
    """Refine K eigenpair candidates to f64-limited residuals.

    Args:
      A64: (N, N) split-f64 original operand.
      lam0: (K,) complex eigenvalue estimates (compute dtype).
      V0: (K, N) complex eigenvector estimates (compute dtype).
      steps: Newton steps (each O(K·N²) after the one batched LU).
      psi_rel: H = A − λI + ψI regularization, relative to ‖A‖_F/√N.

    Returns ``(lam: SplitComplex (K,), V: SplitComplex (K, N), resid: (K,) f64)``
    with ‖v‖ = 1 and resid = ‖Av − λv‖ measured in f64 against A64.
    """
    cdtype = V0.dtype
    rdt = A64.re.dtype
    K, N = V0.shape
    with jax.default_matmul_precision("highest"):
        scale_f, s2_f = scaled_fro(A64.re, A64.im)
        anorm = (scale_f * jnp.sqrt(s2_f / N)).astype(rdt)
        psi = (psi_rel * anorm).astype(jnp.float32)

        smv, _ = _matvec_fns(A64)
        # one batched c64 LU of H_k = A − λ_k I + ψ_k I
        Ac = _to_c(A64, cdtype)
        idx = jnp.arange(N)

        def build_H(l):
            return Ac.at[idx, idx].add(-l)

        def one_round(lam_shift, V, lam_init, psi_k):
            """One fixed-shift round: factor H_k = A − (λ_k − ψ_k) I, run
            masked inverse-iteration pre-sweeps, then ``steps`` bordered-
            Newton steps. Returns (V, lam, resid) with per-step best-keeping.

            ``psi_k`` is PER-CANDIDATE: the ψ continuation below shrinks it
            between rounds, because ψ perturbs the Newton Jacobian itself —
            harmless on normal operands (A and A+ψI share eigenvectors) but
            an O(ψ·non-normality) inexact-Newton stall on non-normal ones.
            Measured (N=4096 Ginibre, c64-floor starts off true pairs):
            3/16 pseudospectrally bad pairs stall at 6e-5..8e-5 with the
            fixed default ψ (=0.3·ψ_abs), while psi_rel=1e-10 converges all
            three to ≤1.2e-13; an exact f64 bordered solve (ψ=0) converges
            quadratically from the stuck state, and a GMRES-IR escalation
            that solved the SAME ψ-shifted system more accurately moved
            nothing — the regularization, not solve accuracy, is the stall."""
            solve = _percand_shifted_solver(
                build_H, lam_shift - psi_k.astype(Ac.dtype), N)

            # Engine leaders that converged at a loose EARLY threshold can
            # sit ~0.1 off their eigenvector; plain Newton from such starts
            # wanders (measured at 8192²: leaders at 2.6e-3 kept their
            # residuals through 5 steps). Two masked shifted-INVERSE-
            # ITERATION sweeps against the same factorization — the
            # reference's own eig mechanism (AMS:270) — pull each crude
            # vector toward the eigenvector nearest its λ (amplification ≈
            # gap/(|λ−λ_true|+ψ) per sweep) at two batched solves' cost;
            # starts already below ~1e3·ε_f32 relative residual are left
            # untouched.
            W0 = smv(V)
            lam_e = _sdiv(_sdot(V, W0), _sdot(V, V))
            r0 = SplitComplex(W0.re - (lam_e.re[:, None] * V.re
                                       - lam_e.im[:, None] * V.im),
                              W0.im - (lam_e.re[:, None] * V.im
                                       + lam_e.im[:, None] * V.re))
            crude = _snorm(r0) > 1.2e-4 * anorm
            for _ in range(2):
                U64 = _from_c(solve(_to_c(V, cdtype)), rdt)
                un = jnp.maximum(_snorm(U64), 1e-30)
                V = SplitComplex(
                    jnp.where(crude[:, None], U64.re / un[:, None], V.re),
                    jnp.where(crude[:, None], U64.im / un[:, None], V.im))

            return _bordered_newton(smv, solve, V, lam_init, steps, cdtype)

        V = _from_c(V0, rdt)
        nrm = jnp.maximum(_snorm(V), 1e-30)
        V = SplitComplex(V.re / nrm[:, None], V.im / nrm[:, None])
        lam_init = SplitComplex(lam0.real.astype(rdt), lam0.imag.astype(rdt))
        lam_shift = lam0
        psi_k = jnp.full((K,), psi, jnp.float32)
        for _ in range(rounds):
            V, lam, resid = one_round(lam_shift, V, lam_init, psi_k)
            # Rayleigh-quotient REFACTORING for the next round: a shift that
            # started between two near-degenerate eigenvalues (engine λ error
            # ≈ local gap — the measured 8192² straggler had a 1.8e-3
            # neighbor at a 2.6e-3 λ error) cannot separate them at a fixed
            # factorization; rebuilding H at the refined λ is classic RQI and
            # converges cubically from there.
            lam_shift = jax.lax.complex(
                lam.re.astype(jnp.float32),
                lam.im.astype(jnp.float32)).astype(cdtype)
            lam_init = lam
            # ψ continuation (see one_round): tie the next round's
            # regularization to the achieved residual so it can never
            # dominate the Jacobian error — 1e-4·resid sits in the
            # measured-converging regime while staying nonzero (the c64 LU
            # never factors an exactly singular H). Non-finite residuals
            # (blown-up candidates) keep the robust base ψ.
            r32 = resid.astype(jnp.float32)
            psi_k = jnp.where(jnp.isfinite(r32),
                              jnp.minimum(psi, 1e-4 * r32), psi)
        return lam, V, resid


# ---------------------------------------------------------------------------
# Singular-triplet refinement
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("steps",))
def refine_svd_triplets(A64: SplitComplex, sig0: jax.Array, U0: jax.Array,
                        V0: jax.Array, steps: int = 4, psi_rel: float = 3e-6
                        ) -> tuple[jax.Array, SplitComplex, SplitComplex,
                                   jax.Array]:
    """Refine K singular-triplet candidates to f64-limited residuals.

    Newton on the augmented Hermitian [[0, A], [Aᴴ, 0]] eigenpair (σ, [u;v]),
    block-eliminated: only G_k = AᴴA − σ_k²I + ψI (N×N) is factored, batched in
    c64. Triplets with σ ≈ 0 (null vectors) are left untouched — their residual
    is already ‖Av‖, which refinement against G cannot improve.

    Returns ``(sigma (K,) f64, U (K,M) split, V (K,N) split, resid (K,) f64)``
    where resid = ‖Av − σu‖ + ‖Aᴴu − σv‖ (reference two-sided residual,
    AMS:301).
    """
    cdtype = V0.dtype
    rdt = A64.re.dtype
    K, N = V0.shape
    with jax.default_matmul_precision("highest"):
        scale_f, s2_f = scaled_fro(A64.re, A64.im)
        anorm = (scale_f * jnp.sqrt(s2_f / min(A64.re.shape))).astype(rdt)
        psi = (psi_rel * anorm).astype(jnp.float32)
        smv, smva = _matvec_fns(A64)
        Ac = _to_c(A64, cdtype)
        G = jnp.conj(Ac.T) @ Ac                            # (N, N) c64 Gram
        idx = jnp.arange(N)
        sig_f = sig0.real.astype(jnp.float32)
        small = sig_f < 1e-6 * jnp.maximum(anorm.astype(jnp.float32), 1e-30)

        def build_H(s):
            return G.at[idx, idx].add(-(s * s) + psi.astype(G.real.dtype))

        solve = _percand_shifted_solver(build_H,
                                        sig_f.astype(Ac.real.dtype), N)

        U = _from_c(U0, rdt)
        V = _from_c(V0, rdt)
        un = jnp.maximum(_snorm(U), 1e-30)
        vn = jnp.maximum(_snorm(V), 1e-30)
        U = SplitComplex(U.re / un[:, None], U.im / un[:, None])
        V = SplitComplex(V.re / vn[:, None], V.im / vn[:, None])
        sig = sig0.real.astype(rdt)

        def resid_of(sig, U, V, Av=None):
            # ``Av``: caller-provided A·V (the Newton body already computed
            # it for the sigma update)
            if Av is None:
                Av = smv(V)
            Ahu = smva(U)
            r1 = SplitComplex(Av.re - sig[:, None] * U.re,
                              Av.im - sig[:, None] * U.im)
            r2 = SplitComplex(Ahu.re - sig[:, None] * V.re,
                              Ahu.im - sig[:, None] * V.im)
            return r1, r2, _snorm(r1) + _snorm(r2)

        # Crude-start pre-polish mirroring refine_eigenpairs: inverse
        # iteration on the shifted Gram pulls v toward the right singular
        # vector nearest σ, and u is re-derived as A v/‖A v‖ (the reference's
        # own one-sided round, AMS:233-235). Null-σ triplets and precise
        # starts are untouched.
        _, _, rn0 = resid_of(sig, U, V)
        crude = (rn0 > 1.2e-4 * anorm) & ~small
        for _ in range(2):
            Vn = _from_c(solve(_to_c(V, cdtype)), rdt)
            vn_ = jnp.maximum(_snorm(Vn), 1e-30)
            Vc = SplitComplex(Vn.re / vn_[:, None], Vn.im / vn_[:, None])
            Avc = smv(Vc)
            an_ = jnp.maximum(_snorm(Avc), 1e-30)
            Uc = SplitComplex(Avc.re / an_[:, None], Avc.im / an_[:, None])
            V = SplitComplex(jnp.where(crude[:, None], Vc.re, V.re),
                             jnp.where(crude[:, None], Vc.im, V.im))
            U = SplitComplex(jnp.where(crude[:, None], Uc.re, U.re),
                             jnp.where(crude[:, None], Uc.im, U.im))

        def body(_, carry):
            sig, U, V, rbest = carry
            # f64 σ update: σ = Re⟨u, Av⟩ for unit u, v
            Av = smv(V)
            sig_new = _sdot(U, Av).re
            r1, r2, rn = resid_of(sig_new, U, V, Av=Av)
            # Newton with dσ folded into the RQ update: A dv − σ du = −r1,
            # Aᴴ du − σ dv = −r2  ⇒  (AᴴA − σ²) dv = −(σ r2 + Aᴴ r1),
            # du = (A dv + r1)/σ  (σ ≈ 0 candidates are masked out entirely)
            Ahr1 = smva(r1)
            rhs = SplitComplex(-(sig_new[:, None] * r2.re + Ahr1.re),
                               -(sig_new[:, None] * r2.im + Ahr1.im))
            dv = solve(_to_c(rhs, cdtype))
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
            keep_new = better
            Uo = SplitComplex(jnp.where(keep_new[:, None], U_new.re, U.re),
                              jnp.where(keep_new[:, None], U_new.im, U.im))
            Vo = SplitComplex(jnp.where(keep_new[:, None], V_new.re, V.re),
                              jnp.where(keep_new[:, None], V_new.im, V.im))
            so = jnp.where(keep_new, sig2, jnp.where(small, sig, sig_new))
            # residual OF THE RETURNED STATE (code-review r3, reproduced on
            # the mesh variant): better keeps rn2, rejected keeps rn
            # (evaluated exactly at the returned sig_new/U/V), sigma~0
            # pass-throughs keep their entry residual; the old running min
            # folded in residuals of never-returned states and let a NaN
            # trial poison the report
            return so, Uo, Vo, jnp.where(small, rbest,
                                         jnp.where(keep_new, rn2, rn))

        r10, r20, rn0 = resid_of(sig, U, V)
        sig, U, V, resid = jax.lax.fori_loop(0, steps, body, (sig, U, V, rn0))
        return sig, U, V, resid
