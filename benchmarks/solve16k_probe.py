"""End-to-end 16384² single-device solve through the public API.

The operand is the headline family (bench.py's κ-controlled c64 system) at
16384², made on the device and passed as a device-resident array. The
shared factorization is rebuilt inside the evolve loop when the Ψ rung
moves (``host_refactor`` auto, off on the GPU). The first call pays the
compiles; the second is the measured time. The true residual of the
returned x is checked on the device in native complex128.

Prints one JSON line. Run: python benchmarks/solve16k_probe.py [--n 16384]
"""
import argparse
import json
import pathlib
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--cands", type=int, default=16)
    ap.add_argument("--cond", type=float, default=1e6)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import maus_tpu
    from bench import _device_problem, device_info
    from maus_tpu.utils.compile_cache import enable as enable_compile_cache

    enable_compile_cache()
    A, b = jax.block_until_ready(
        _device_problem(args.n, args.cond, jnp.complex64))

    def solve():
        return maus_tpu.solve(A, b, tol=args.tol,
                              num_candidates=args.cands)

    t0 = time.perf_counter()
    solve()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = solve()
    elapsed = time.perf_counter() - t0

    @jax.jit
    def rel_c128(A_, x_, b_):
        with jax.default_matmul_precision("highest"):
            b128 = b_.astype(jnp.complex128)
            r = b128 - A_.astype(jnp.complex128) @ x_
            return jnp.linalg.norm(r) / jnp.linalg.norm(b128)

    rel = float(rel_c128(A, jnp.asarray(rep.best()[0], jnp.complex128), b))
    print(json.dumps({
        "metric": f"time_to_tol({args.tol:g}) N={args.n} "
                  f"illcond(k={args.cond:g}) pop={args.cands}",
        "value": elapsed, "unit": "s", "setup_s": setup_s,
        "iterations": rep.iterations, "true_rel_c128": rel,
        "device": device_info()}))
    return 0 if rel <= args.tol else 1


if __name__ == "__main__":
    raise SystemExit(main())
