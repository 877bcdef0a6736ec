"""Benchmark harness — the headline linear cell (BASELINE.md / BASELINE.json):

    time-to-tol ‖Ax−b‖/‖b‖ ≤ 1e-8 on a 4096² ill-conditioned dense complex system,
    full candidate-population sweep, vs the SciPy reference modeled on CPU.

Prints ONE JSON line with the warm solve time (``value``, median of the timed
repetitions), the compile time as set-up, the device it ran on and the card's
name and power limit. It measures on the GPU only: on any other backend it
exits non-zero without a result.

``vs_baseline`` models the reference's cost for the same work: the reference
performs one LAPACK ``sla.solve`` per candidate per iteration (AMS:224-225,
AMS:59 — no factorization reuse); its modeled time is (measured scipy c128
solve time at N) × (population size) × (our iteration count, i.e. granting the
reference our own convergence speed, which it does not have — SURVEY.md §0.1
measured it never converging at all).

Usage:  python bench.py [--quick] [--n N] [--cands K]
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def _device_problem(n: int, cond: float, dtype, seed: int = 0):
    """Generate the controlled-κ system ON DEVICE (host QR at 4096² costs
    minutes). A = Q1 · diag(logspace) · Q2ᴴ, b random. Built at HIGHEST
    matmul precision: a TF32 product would perturb the small singular values
    by ~1e-3·‖A‖ and so change κ."""
    import jax
    import jax.numpy as jnp

    k1, k2, k3, k4, kb = jax.random.split(jax.random.PRNGKey(seed), 5)
    rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64

    def qhaar(ka, kb_):
        # lax.complex builds the pair in the target precision directly
        g = jax.lax.complex(jax.random.normal(ka, (n, n), rdt),
                            jax.random.normal(kb_, (n, n), rdt)).astype(dtype)
        q, r = jnp.linalg.qr(g)
        d = jnp.diagonal(r)
        return q * (d / jnp.abs(d))[None, :]

    @jax.jit
    def build():
        with jax.default_matmul_precision("highest"):
            q1 = qhaar(k1, k2)
            q2 = qhaar(k3, k4)
            s = jnp.logspace(0.0, -np.log10(cond), n, dtype=rdt).astype(dtype)
            A = (q1 * s[None, :]) @ q2.conj().T
            b = jax.lax.complex(
                jax.random.normal(kb, (n,), rdt),
                jax.random.normal(jax.random.fold_in(kb, 1), (n,), rdt)
            ).astype(dtype)
            return A, b

    return build()


# Measured c128 scipy.linalg.solve per-solve times on the build host's CPU
# (2026-08-16, OpenBLAS, median of 2-3 reps; see BASELINE.md "Measured
# SciPy/LAPACK per-solve floor").
_SCIPY_SOLVE_MEASURED = {1024: 0.218, 2048: 1.371, 4096: 11.010}


def _measure_scipy_solve(n_model: int, n_target: int) -> float:
    """Per-solve LAPACK time at n_target: measured value when recorded,
    otherwise nearest measured size scaled by the O(N³) flop ratio, otherwise
    measured live at n_model and scaled."""
    if n_target in _SCIPY_SOLVE_MEASURED:
        return _SCIPY_SOLVE_MEASURED[n_target]
    anchor = min(_SCIPY_SOLVE_MEASURED, key=lambda n: abs(n - n_target))
    if 0.25 <= n_target / anchor <= 4.0:
        return _SCIPY_SOLVE_MEASURED[anchor] * (n_target / anchor) ** 3
    import scipy.linalg as sla

    rng = np.random.default_rng(0)
    A = rng.standard_normal((n_model, n_model)) \
        + 1j * rng.standard_normal((n_model, n_model))
    b = rng.standard_normal(n_model) + 0j
    sla.solve(A, b)                       # warm BLAS threads
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        sla.solve(A, b)
    t_model = (time.perf_counter() - t0) / reps
    return t_model * (n_target / n_model) ** 3


def nvidia_smi_name_power() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them (first
    card), read in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    """The device as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def build_solve(n: int, cands: int = 16, cond: float = 1e6, tol: float = 1e-8,
                seed: int = 0):
    """The headline solve as ONE jitted program — evolve to the c64 floor,
    best-candidate selection, split-f64 refinement — and its arguments.
    Returns ``(fn, args, cfg)``; ``fn(*args)`` gives ``(xs, rel, iters)``."""
    import jax
    import jax.numpy as jnp

    from maus_tpu.core.types import (ProblemKnowledge, ProblemType,
                                     SolverConfig)
    from maus_tpu.ops.refine import SplitComplex, refine_split_c64exact
    from maus_tpu.solver import evolve as ev

    dtype = jnp.complex64
    eps = float(np.finfo(np.float32).eps)
    A, b = _device_problem(n, cond, dtype, seed=seed)
    # c64 convergence floor for this κ (refinement closes the rest, see
    # ops/refine)
    floor = max(50 * eps, 2 * eps * cond)
    cfg = SolverConfig(problem_type=ProblemType.SOLVE_LINEAR_SYSTEM,
                       num_candidates=cands, tol=tol, dtype=dtype,
                       convergence_floor=floor, refine=True,
                       max_refine_steps=60, host_refactor=False)
    kn = ProblemKnowledge(shape=(n, n), cond_estimate=cond)
    key = jax.random.PRNGKey(seed + 1)
    max_iters = 50
    b64 = jax.jit(lambda v: SplitComplex(v.real.astype(jnp.float64),
                                         v.imag.astype(jnp.float64)))(b)

    @jax.jit
    def solve_fused(A_, b_, key_, b64_, tol_):
        carry, _ = ev.evolve_while(cfg, kn, A_, b_, key_, max_iters, 1)
        pop = carry.pop
        best = jnp.argmin(jnp.where(jnp.isfinite(pop.residual),
                                    pop.residual, jnp.inf))
        xs, rel = refine_split_c64exact(A_, carry.fac, b64_, pop.v[best],
                                        steps=cfg.max_refine_steps, tol=tol_)
        return xs, rel, carry.iteration

    return solve_fused, (A, b, key, b64, tol * 0.3), cfg


def run(n: int = 4096, cands: int = 16, cond: float = 1e6, tol: float = 1e-8,
        seed: int = 0, reps: int = 3) -> dict:
    """Compile, then time ``reps`` warm runs of the headline program; returns
    the result dict. Raises on any backend but the GPU."""
    import jax

    jax.config.update("jax_enable_x64", True)   # f64 split residuals
    if jax.devices()[0].platform != "gpu":
        raise RuntimeError("bench.py measures on the GPU only; JAX found "
                           f"{jax.devices()[0].platform!r}")
    from maus_tpu.utils.compile_cache import cache_dir, enable

    enable()
    fn, args, cfg = build_solve(n, cands, cond, tol, seed)
    jax.block_until_ready(args[0])

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))       # compile + first run
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    _, rel, iters = out
    rel_f, iters_f = float(rel), int(iters)
    elapsed = statistics.median(times)
    ok = rel_f <= tol

    # reference model: K LAPACK solves per iteration, our iteration count
    t_solve = _measure_scipy_solve(min(1024, n), n)
    ref_time = t_solve * cands * max(iters_f, 1)
    return {
        "metric": f"time_to_tol({tol:g}) N={n} illcond(k={cond:g}) "
                  f"pop={cands}",
        "value": elapsed,
        "unit": "s",
        "times_s": times,
        "setup_s": setup_s,
        "achieved_rel": rel_f,
        "converged": ok,
        "iterations": iters_f,
        "vs_baseline": ref_time / elapsed if elapsed > 0 else 0.0,
        # every candidate consumes one regularized solve per iteration
        "solves_per_s": cands * max(iters_f, 1) / elapsed
        if elapsed > 0 else 0.0,
        "device": device_info(),
        "gpu": nvidia_smi_name_power(),
        "compile_cache": cache_dir(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="N=512 smoke config")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--cond", type=float, default=1e6)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()
    try:
        result = run(n=args.n or (512 if args.quick else 4096),
                     cands=args.cands, cond=args.cond, tol=args.tol)
    except RuntimeError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0 if result["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
