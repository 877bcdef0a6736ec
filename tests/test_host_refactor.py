"""Host-mediated refactorization mode (``SolverConfig.host_refactor``).

For a backend whose compiler caps a conditional branch's scratch memory
(``backend.branch_memory_cap``), a large shared-factorization QR does not
compile inside the evolve loop's ``lax.cond`` while the identical QR
compiles at program top level. In host mode the
loop exits with ``carry.refactor_psi`` set instead of refactorizing in-program;
the api driver rebuilds the factorization in a standalone program and
re-enters. These tests pin the two contracts:

* the machinery actually round-trips (exit → host refactor → re-entry picks up
  exactly where the fused path would be), and
* the trajectory is identical to the in-program ``lax.cond`` path on the same
  seeds (the freeze discards the flagged iteration entirely, and the re-entered
  iteration recomputes the same diagnostics/strategy from the same carry).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from maus_tpu.core.types import ProblemKnowledge, ProblemType, SolverConfig
from maus_tpu.solver import api as api_mod
from maus_tpu.solver import evolve as evolve_mod


def _ill_conditioned(n=64, kappa=1e6, seed=0):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(kappa), n)
    A = (U * s) @ V.conj().T
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


def test_refactor_handoff_roundtrip():
    """Force a Ψ mismatch: the loop must exit flagged, the host resolve must
    rebuild fac at the requested Ψ, and re-entry must complete the run."""
    A, b = _ill_conditioned()
    cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                       num_candidates=8, tol=1e-8, host_refactor=True)
    s = api_mod.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           config=cfg, seed=1)
    kn, key = s.knowledge, s._key
    carry0 = evolve_mod.init_carry(cfg, kn, s.A, key)
    # sabotage the cached Ψ so iteration 0's rung comparison fails
    bad = carry0._replace(psi_cached=jnp.asarray(0.0, jnp.float32))
    carry, _ = evolve_mod.evolve_while(cfg, kn, s.A, s.b, key, 50, 1,
                                       carry0=bad)
    # the loop must have exited immediately, asking the host for a rebuild
    assert int(carry.iteration) == 0
    rp = float(carry.refactor_psi)
    assert rp > 0.0
    fixed = s._resolve_refactor(carry)
    assert fixed is not None
    assert float(fixed.refactor_psi) == 0.0
    assert float(fixed.psi_cached) == rp
    # re-entry completes the run and never asks again (Ψ stays on its rung)
    carry2, _ = evolve_mod.evolve_while(cfg, kn, s.A, s.b, key, 50, 1,
                                        carry0=fixed)
    assert float(carry2.refactor_psi) == 0.0
    assert int(carry2.iteration) > 0


@pytest.mark.parametrize("collect_metrics", [False, True])
def test_trajectory_parity_with_fused_path(collect_metrics):
    """host_refactor=True must reproduce the lax.cond path's trajectory
    exactly: same iteration count, same final residuals, same solution."""
    A, b = _ill_conditioned()
    reports = {}
    for hr in (False, True):
        cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                           num_candidates=8, tol=1e-8, host_refactor=hr)
        s = api_mod.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM,
                               b_vector=b, config=cfg, seed=3)
        reports[hr] = s.evolve(60, collect_metrics=collect_metrics)
    r0, r1 = reports[False], reports[True]
    assert r0.iterations == r1.iterations
    assert r0.num_distinct == r1.num_distinct
    assert len(r0.residuals) == len(r1.residuals)
    for a, c in zip(r0.residuals, r1.residuals):
        assert a == pytest.approx(c, rel=1e-6, abs=1e-14)
    if r0.solutions:
        x0, x1 = r0.solutions[0][0], r1.solutions[0][0]
        assert np.allclose(x0, x1, rtol=1e-7, atol=1e-12)
    if collect_metrics:
        m0, m1 = r0.metrics, r1.metrics
        assert m0 is not None and m1 is not None
        np.testing.assert_allclose(np.asarray(m0["num_distinct"]),
                                   np.asarray(m1["num_distinct"]))


def test_scan_hosted_chunk_stitching():
    """Force a refactor on the scan path's very first iteration: the stitched
    metrics must contain exactly num_iterations rows with the executed rows
    first (no frozen zero-rows interleaved before real ones)."""
    A, b = _ill_conditioned()
    cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                       num_candidates=8, tol=1e-8, host_refactor=True,
                       capture_history=True)
    s = api_mod.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           config=cfg, seed=1)
    carry0 = evolve_mod.init_carry(cfg, s.knowledge, s.A, s._key)
    bad = carry0._replace(psi_cached=jnp.asarray(0.0, jnp.float32))
    num_iters = 12
    carry, metrics = s._scan_hosted(num_iters, bad)
    assert float(carry.refactor_psi) == 0.0
    rows = np.asarray(metrics.num_distinct)
    assert rows.shape[0] == num_iters
    # the run executed some iterations: landscape energy of executed rows is
    # non-zero while frozen rows (if any, at the END only) are exactly zero
    executed = np.asarray(metrics.avg_residual) != 0.0
    ran = int(carry.iteration)
    assert ran > 0
    assert bool(executed[:ran].all())


def test_auto_enable_policy():
    """host_refactor=None resolves to a concrete bool at construction; small
    problems on CPU never enable it."""
    A, b = _ill_conditioned(n=32)
    s = api_mod.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                           seed=0)
    assert s.config.host_refactor is False


def _indefinite_declared_hpd(n=128, cond=1e6, seed=0):
    """Hermitian operand with exactly one negative eigenvalue (-1/cond) that
    the HOST wrongly declares positive definite — the production trigger for
    Ψ-ladder escalation: the shared Cholesky of A + ΨI is NaN until Ψ exceeds
    |λ_min| (the reference escalates on LinAlgError the same way, AMS:44)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), n)
    s[-1] = -1.0 / cond
    A = (Q * s) @ Q.conj().T
    A = (A + A.conj().T) / 2
    xt = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xt /= np.linalg.norm(xt)
    return A, A @ xt


def test_fac_all_finite_gate():
    """The seeding gate itself: finite pytrees pass, any NaN leaf fails,
    int leaves are ignored."""
    from maus_tpu.ops.batched_solve import QRFactors
    good = QRFactors(jnp.ones((4, 4), jnp.complex64),
                     jnp.eye(4, dtype=jnp.complex64))
    assert api_mod._fac_all_finite(good)
    bad = QRFactors(jnp.ones((4, 4), jnp.complex64)
                    * jnp.asarray(jnp.nan, jnp.complex64),
                    jnp.eye(4, dtype=jnp.complex64))
    assert not api_mod._fac_all_finite(bad)
    assert api_mod._fac_all_finite((jnp.arange(3),))  # ints: vacuously finite


def test_nan_cholesky_carry_never_seeds_refinement():
    """Declared-HPD operand with an indefinite defect: the evolve carry can exit with frustration
    decayed to 0 while holding NaN Cholesky factors — seeding those into
    _fac_cache made IR/GMRES-IR silently return inf. The gate must reject
    them, refinement must fall back to a fresh QR, and (the user-visible
    contract) the refined residual must meet tol; host handoffs must have
    fired along the way."""
    A, b = _indefinite_declared_hpd()
    eps = float(np.finfo(np.float32).eps)
    cond = 1e6
    kn = ProblemKnowledge(shape=A.shape, cond_estimate=cond,
                          is_hermitian=True, is_positive_definite=True)
    cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                       num_candidates=8, tol=1e-8, dtype=jnp.complex64,
                       psi_base=1e-12,
                       convergence_floor=max(50 * eps, 2 * eps * cond),
                       refine=True, max_refine_steps=60, host_refactor=True)

    handoffs = []
    rejected = []
    orig_resolve = api_mod.resolve_refactor_carry
    orig_gate = api_mod._fac_all_finite

    def counting(Aop, carry, hpd=False):
        out = orig_resolve(Aop, carry, hpd=hpd)
        if out is not None:
            handoffs.append(float(carry.refactor_psi))
        return out

    def gate_spy(fac):
        ok = orig_gate(fac)
        rejected.append(not ok)
        return ok

    api_mod.resolve_refactor_carry = counting
    api_mod._fac_all_finite = gate_spy
    try:
        s = api_mod.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM,
                               b_vector=b, config=cfg, knowledge=kn, seed=1)
        rep = s.evolve(max_iterations=80)
    finally:
        api_mod.resolve_refactor_carry = orig_resolve
        api_mod._fac_all_finite = orig_gate

    assert len(handoffs) >= 1          # the Ψ ladder actually fired on-host
    assert rep.residuals, "no solution returned"
    assert rep.residuals[0] <= cfg.tol
    # the carry's Cholesky was NaN and must have been rejected by the gate
    assert any(rejected)
    # refinement's cache, if populated, holds the fallback QR — finite
    if s._fac_cache is not None:
        assert api_mod._fac_all_finite(s._fac_cache)


@pytest.mark.parametrize("collect_metrics", [False, True])
def test_hoisted_hessenberg_parity(monkeypatch, collect_metrics):
    """Large-N eig hoists the shared Hessenberg reduction into a standalone
    program (api._host_hessenberg_program) and feeds it to the evolve loop as
    data, so its temps are not stacked on the loop program's. The
    hoisted run must find the same eigenpairs as the fused-construction run
    on the same seeds, and the cache must actually be built and reused."""
    rng = np.random.default_rng(7)
    n = 48
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))

    def run():
        s = api_mod.MausSolver(A, ProblemType.EIGENVALUE, seed=3)
        rep = s.evolve(max_iterations=60, collect_metrics=collect_metrics)
        return s, rep

    s0, base = run()
    assert s0._hess_hoist is None           # default: fused construction
    monkeypatch.setattr(api_mod, "_HESS_HOIST_MIN_N", 1)
    s1, hoisted = run()
    assert s1._hess_hoist is not None       # built once, as its own program
    # same distinct eigenvalues at the same residual quality
    assert hoisted.num_distinct == base.num_distinct
    lam_b = np.sort_complex(np.asarray([sol[0] for sol in base.solutions]))
    lam_h = np.sort_complex(np.asarray([sol[0] for sol in hoisted.solutions]))
    np.testing.assert_allclose(lam_h, lam_b, rtol=1e-6, atol=1e-8)
    ev = np.sort_complex(np.linalg.eigvals(A))
    for lam in lam_h:
        assert np.min(np.abs(ev - lam)) < 1e-6 * np.linalg.norm(A)


def test_hoist_cache_invalidated_on_swap(monkeypatch):
    """update_problem must drop the hoisted Hessenberg cache — it belongs to
    the OLD operand (scenario-1 swap semantics, AMS:645-652)."""
    monkeypatch.setattr(api_mod, "_HESS_HOIST_MIN_N", 1)
    rng = np.random.default_rng(11)
    n = 32
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    s = api_mod.MausSolver(A, ProblemType.EIGENVALUE, seed=5)
    s.evolve(max_iterations=25)
    assert s._hess_hoist is not None
    A2 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    s.update_problem(matrix=A2)
    assert s._hess_hoist is None
    rep2 = s.evolve(max_iterations=60)
    ev2 = np.sort_complex(np.linalg.eigvals(A2))
    for lam, _v in rep2.solutions:
        assert np.min(np.abs(ev2 - lam)) < 1e-6 * np.linalg.norm(A2)
