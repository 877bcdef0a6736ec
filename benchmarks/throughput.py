"""Throughput benchmark: candidate-population solves/sec (the BASELINE.md
throughput metric) — how many Ψ-regularized shifted factorize+solve operations
per second the batched engine sustains, vs the measured single-threaded scipy
floor (BASELINE.md row 9: ≈1.8k solves/s at N=64 on CPU).

Usage: python benchmarks/throughput.py [--n 256] [--cands 32] [--reps 10]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--cands", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from maus_tpu.ops.batched_solve import batched_shifted_solve

    n, K = args.n, args.cands
    key = jax.random.PRNGKey(0)
    def mk(k, shape):
        return jax.lax.complex(
            jax.random.normal(jax.random.fold_in(k, 0), shape, jnp.float32),
            jax.random.normal(jax.random.fold_in(k, 1), shape, jnp.float32)) \
            .astype(jnp.complex64)
    A = mk(key, (n, n))
    lams = mk(jax.random.fold_in(key, 2), (K,))
    B = mk(jax.random.fold_in(key, 3), (K, n))
    stuck = jnp.zeros((K,), jnp.int32)

    with jax.default_matmul_precision("highest"):
        f = jax.jit(lambda A, lams, B: batched_shifted_solve(
            A, lams, stuck, 1e-12, 1.0, B)[0])
    jax.block_until_ready(f(A, lams, B))           # compile + warm
    t0 = time.perf_counter()
    for _i in range(args.reps):
        out = f(A, lams, B)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.reps
    solves_per_sec = K / dt

    # scipy floor: one LAPACK solve per candidate (reference inner loop)
    import scipy.linalg as sla

    rng = np.random.default_rng(0)
    Ah = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    bh = rng.standard_normal(n) + 0j
    sla.solve(Ah, bh)
    t0 = time.perf_counter()
    reps = 5
    for _i in range(reps):
        sla.solve(Ah, bh)
    scipy_rate = reps / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": f"candidate_shifted_solves_per_sec N={n} pop={K}",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / scipy_rate, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
