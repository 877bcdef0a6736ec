"""On-chip AGE + scenario-suite rows (BASELINE rows 2 and 10 have only the
reference's CPU numbers so far).

Three measurements, one JSON line each:

1. ``age 5x20`` — the reference-parity workload (5 genesis cycles x 20
   expression candidates, diffusion grid 50x50; KAIROSAGE:283-314 defaults).
   Reference: completes < 240 s on one CPU core with mean spread fitness
   0.63-0.66 (BASELINE row 10).
2. ``age stageIII throughput`` — the evaluation hot loop alone (the
   reference's 50k-recursive-Python-call inner loop, SURVEY §3.5) as ONE
   jitted device program over a large candidate batch: tape-compiled
   expressions -> vmapped diffusion scan. Reported as simulations/s and
   cell-steps/s. Host-side weave/sympy novelty is excluded on purpose — this
   row isolates what the rebuild moved on device.
3. ``scenario suite`` — the reference's 4-scenario demo (AMS:641-665)
   end-to-end through the public API. Reference: 6.2 s patched, passing
   0/1, 2/8, 2/8, 1/4; ours must pass 1/1, 8/8, 8/8, 2/2 (the
   tests/test_solver_e2e.py gates).

Usage: python -u benchmarks/age_probe.py [--stage3-cands 4096]
"""
from __future__ import annotations

import argparse
import json
import time


def row_age_reference_parity():
    from maus_tpu.age import AgeConfig, GenesisEngine

    eng = GenesisEngine(AgeConfig(), seed=0, verbose=False)
    t0 = time.perf_counter()
    summaries = eng.run(5)
    dt = time.perf_counter() - t0
    out = {"metric": "age 5x20 cycles (reference parity)",
           "time_s": round(dt, 3),
           "vs_reference_240s": round(240.0 / dt, 1),
           "best_fitness": round(max(s["best_fitness"] for s in summaries), 3),
           "library": summaries[-1]["library_size"]}
    print(json.dumps(out), flush=True)


def row_stage3_throughput(n_cands: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from maus_tpu.age import AgeConfig, GenesisEngine
    from maus_tpu.age import diffusion
    from maus_tpu.age.tape import compile_tree, stack_tapes

    c = AgeConfig()
    eng = GenesisEngine(c, seed=1, verbose=False)
    genomes = []
    while len(genomes) < n_cands:            # weave in reference-sized waves
        genomes.extend(eng.stage_II_weave())
    genomes = genomes[:n_cands]
    tapes = stack_tapes([compile_tree(g.tree, c.variables) for g in genomes])
    tapes = {k: jnp.asarray(v) for k, v in tapes.items()}
    kern = jnp.asarray(np.asarray(c.base_kernel, np.float32))

    def run():
        fit = diffusion.population_fitness(
            tapes, c.diffusion_n, c.diffusion_t, kern)
        return jax.block_until_ready(fit)

    fit = run()                              # compile + warm
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        fit = run()
    dt = (time.perf_counter() - t0) / reps
    cell_steps = n_cands * c.diffusion_n * c.diffusion_t
    out = {"metric": f"age stageIII throughput ({n_cands} cands, "
                     f"{c.diffusion_n}x{c.diffusion_t} grid)",
           "time_s": round(dt, 4),
           "sims_per_s": round(n_cands / dt),
           "cell_steps_per_s": round(cell_steps / dt),
           "mean_fitness": round(float(np.asarray(fit).mean()), 3)}
    print(json.dumps(out), flush=True)


def row_scenarios():
    import maus_tpu
    from maus_tpu.problems import generators as gen

    def suite():
        ok = []
        A, b = gen.dynamic_solve_system(5, t_step=19, time_max_iter=20)
        rep = maus_tpu.solve(A, b, tol=1e-7, max_iterations=50,
                             num_candidates=15)
        ok.append(rep.num_distinct >= 1)
        A = gen.laplace_like_complex(8, make_hermitian=False)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=80, num_candidates=30)
        ok.append(rep.num_distinct == 8)
        A = gen.laplace_like_complex(8, make_hermitian=True)
        rep = maus_tpu.eig(A, tol=1e-7, max_iterations=50, num_candidates=30)
        ok.append(rep.num_distinct == 8)
        A = gen.low_rank_svd_matrix(5, 4, target_rank=2)
        rep = maus_tpu.svd(A, tol=1e-6, max_iterations=100, num_candidates=25)
        ok.append(rep.num_distinct >= 2)
        return ok

    ok = suite()                             # compile + warm
    t0 = time.perf_counter()
    ok = suite()
    dt = time.perf_counter() - t0
    out = {"metric": "4-scenario demo suite (warm)", "time_s": round(dt, 3),
           "vs_reference_6.2s": round(6.2 / dt, 1),
           "passed": f"{sum(ok)}/4",
           "scenario_ok": ok}
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage3-cands", type=int, default=4096)
    ap.add_argument("--skip-scenarios", action="store_true")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)   # split-f64 finisher planes

    from maus_tpu.utils.compile_cache import enable as enable_cache

    enable_cache()
    row_age_reference_parity()
    row_stage3_throughput(args.stage3_cands)
    if not args.skip_scenarios:
        row_scenarios()
    return 0


if __name__ == "__main__":
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    sys.exit(main())
