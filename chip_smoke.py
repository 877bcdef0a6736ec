"""Proof that maus_tpu runs on an NVIDIA GPU.

Drives the linear, eig, SVD and AGE paths once through the public entry
points at real sizes, checks every result against numpy in complex128, and
runs the GPU test tier:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh path and its
                                   # one-card comparison, nothing else

Each phase prints one JSON line (a failed phase prints its error and the
script goes on to the next, then exits non-zero). The last line is
``{"ok": true, "device": {...}}`` only when every phase passed. There is no
CPU fallback: on any other platform the script exits non-zero at once.
Every phase function takes its sizes as arguments, so the CPU tests can call
it small.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _median_time(fn, reps: int) -> float:
    """Median wall time of ``reps`` warm calls of ``fn`` (which must block on
    its result); one untimed call first."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _host_rel_residual(A_h, x, b_h) -> float:
    """‖Ax − b‖/‖b‖ in numpy complex128."""
    return float(np.linalg.norm(A_h @ x - b_h) / np.linalg.norm(b_h))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    """Platform, device kind and count as JAX reports them; the card's name
    and power limit from nvidia-smi; the compile-cache directory."""
    from bench import device_info, nvidia_smi_name_power
    from maus_tpu.utils.compile_cache import cache_dir, enable

    enable()
    return {"device": device_info(), "gpu": nvidia_smi_name_power(),
            "compile_cache": cache_dir()}


def phase_linear(n: int = 4096, cond: float = 1e6, cands: int = 16,
                 tol: float = 1e-8) -> dict:
    """The headline linear cell through ``maus_tpu.solve`` on a device-made
    κ-controlled c64 operand; the true residual is checked on the host."""
    import jax
    import jax.numpy as jnp

    import maus_tpu
    from bench import _device_problem
    from maus_tpu.core.types import ProblemType
    from maus_tpu.solver import evolve as ev

    A, b = jax.block_until_ready(_device_problem(n, cond, jnp.complex64))
    t0 = time.perf_counter()
    maus_tpu.solve(A, b, tol=tol, num_candidates=cands)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = maus_tpu.solve(A, b, tol=tol, num_candidates=cands)
    warm_s = time.perf_counter() - t0

    x = rep.best()[0]
    rel = _host_rel_residual(np.asarray(A).astype(np.complex128), x,
                             np.asarray(b).astype(np.complex128))
    _check(rel <= tol, f"host c128 true residual {rel:.3e} <= {tol:g}")

    s = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM, b_vector=b,
                            initial_num_candidates=cands,
                            global_convergence_tol=tol)
    ma = ev.evolve_while.lower(s.config, s.knowledge, s.A, s.b, s._key, 100,
                               s.target_solutions).compile().memory_analysis()
    return {"n": n, "cond": cond, "converged": rep.converged,
            "iterations": rep.iterations, "setup_s": setup_s,
            "warm_s": warm_s, "reported_rel": rep.residuals[0],
            "host_c128_rel": rel,
            "evolve_memory": {
                "argument_bytes": ma.argument_size_in_bytes,
                "output_bytes": ma.output_size_in_bytes,
                "temp_bytes": ma.temp_size_in_bytes,
                "generated_code_bytes": ma.generated_code_size_in_bytes},
            "peak_bytes_in_use": _peak_bytes()}


def phase_linear_large(n: int = 16384, cond: float = 1e6, cands: int = 16,
                       tol: float = 1e-8) -> dict:
    """The same family at a size where the in-loop refactorization runs at
    full scale (host_refactor left to auto); true residual in native c128 on
    the device."""
    import jax
    import jax.numpy as jnp

    import maus_tpu
    from bench import _device_problem
    from maus_tpu.core import backend

    A, b = jax.block_until_ready(_device_problem(n, cond, jnp.complex64))
    t0 = time.perf_counter()
    rep = maus_tpu.solve(A, b, tol=tol, num_candidates=cands)
    wall_s = time.perf_counter() - t0

    @jax.jit
    def rel_c128(A_, x_, b_):
        with jax.default_matmul_precision("highest"):
            b128 = b_.astype(jnp.complex128)
            r = b128 - A_.astype(jnp.complex128) @ x_
            return jnp.linalg.norm(r) / jnp.linalg.norm(b128)

    rel = float(rel_c128(A, jnp.asarray(rep.best()[0], jnp.complex128), b))
    _check(rel <= tol, f"device c128 true residual {rel:.3e} <= {tol:g}")
    return {"n": n, "cond": cond,
            "host_refactor": backend.needs_host_refactor(n),
            "converged": rep.converged, "iterations": rep.iterations,
            "wall_s_with_compile": wall_s, "reported_rel": rep.residuals[0],
            "device_c128_rel": rel, "peak_bytes_in_use": _peak_bytes()}


def phase_residual(n: int = 4096, reps: int = 20, seed: int = 3) -> dict:
    """The native f64 residual that refinement certifies with, against
    numpy c128 on the host, and timed against the exact-slicing bf16 ladder
    it replaced (both with their per-operand preparation hoisted)."""
    import jax
    import jax.numpy as jnp

    from bench import _device_problem
    from maus_tpu.ops.refine import (SplitComplex, _residual_3m,
                                     _sliced_residual, make_true_resid,
                                     slice_split_matrix)

    A, _ = _device_problem(n, 1e6, jnp.complex64)
    rng = np.random.default_rng(seed)
    x_h = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b_h = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    A_h = np.asarray(A).astype(np.complex128)

    def planes(z):
        return SplitComplex(jnp.asarray(z.real), jnp.asarray(z.imag))

    A64 = jax.jit(lambda a: SplitComplex(a.real.astype(jnp.float64),
                                         a.imag.astype(jnp.float64)))(A)
    x64, b64 = planes(x_h), planes(b_h)
    with jax.default_matmul_precision("highest"):
        r = jax.jit(lambda a, x, b: make_true_resid(a, b)(x))(A64, x64, b64)
        r_dev = np.asarray(r.re) + 1j * np.asarray(r.im)
        r_host = b_h - A_h @ x_h
        # |fl(Ax) − Ax| ≤ γ_N·|A||x| on each side; the 3M form adds one more
        # such term, and the two sides sum in different orders
        bound = 8 * n * np.finfo(np.float64).eps \
            * np.max(np.sum(np.abs(A_h), axis=1)) * np.max(np.abs(x_h))
        err = float(np.max(np.abs(r_dev - r_host)))
        _check(err <= bound, f"native residual |Δr|∞ {err:.3e} <= {bound:.3e}")

        Asum = jax.jit(lambda a: a.re + a.im)(A64)
        native = jax.jit(_residual_3m)
        t_native = _median_time(
            lambda: jax.block_until_ready(native(A64, Asum, x64, b64)), reps)
        sp = jax.block_until_ready(jax.jit(slice_split_matrix)(A64))
        sliced = jax.jit(_sliced_residual)
        rs = sliced(sp, x64, b64)
        err_s = float(np.max(np.abs(np.asarray(rs.re) + 1j * np.asarray(rs.im)
                                    - r_host)))
        _check(err_s <= bound, f"ladder residual |Δr|∞ {err_s:.3e}")
        t_sliced = _median_time(
            lambda: jax.block_until_ready(sliced(sp, x64, b64)), reps)
    return {"n": n, "max_abs_diff_vs_numpy": err, "bound": float(bound),
            "ladder_max_abs_diff": err_s, "native_s": t_native,
            "ladder_s": t_sliced, "ladder_over_native": t_sliced / t_native}


def _eig_operand(n: int, kind: str, seed: int = 0):
    """Ginibre-type general operand, or its Hermitian part (the families of
    benchmarks/spectral_large_probe.py)."""
    from benchmarks.spectral_large_probe import _device_operand

    return _device_operand(n, kind, seed=seed)


def phase_eig(n: int = 2048, targets: int = 16, tol: float = 1e-8,
              hess_n: int = 4096, hess_k: int = 32) -> dict:
    """``maus_tpu.eig`` on a general and a Hermitian operand, every returned
    pair checked in numpy c128; then the shifted Hessenberg sweep alone."""
    import jax
    import jax.numpy as jnp

    import maus_tpu
    from maus_tpu.ops.hessenberg import solve_shifted_hessenberg

    out = {"n": n, "targets": targets}
    for kind in ("general", "hermitian"):
        A = _eig_operand(n, kind)
        t0 = time.perf_counter()
        rep = maus_tpu.eig(A, tol=tol, max_iterations=100,
                           num_candidates=2 * targets,
                           target_solutions=targets)
        wall_s = time.perf_counter() - t0
        A_h = np.asarray(A).astype(np.complex128)
        res = [float(np.linalg.norm(A_h @ v - lam * v) / np.linalg.norm(v))
               for lam, v in rep.solutions]
        _check(rep.num_distinct >= targets,
               f"{kind} eig: {rep.num_distinct} distinct < {targets}")
        _check(max(res) <= tol,
               f"{kind} eig: worst numpy residual {max(res):.3e} <= {tol:g}")
        out[kind] = {"num_distinct": rep.num_distinct,
                     "iterations": rep.iterations,
                     "wall_s_with_compile": wall_s,
                     "max_numpy_resid": max(res)}
        del A

    # A random Hessenberg matrix alone has exponentially bad conditioning
    # (its solves overflow c64); shifted by 6 against |λ| ≲ 1 and a norm
    # ≲ 2 the systems stay well-conditioned. The sweep's cost does not
    # depend on the values.
    rng = np.random.default_rng(5)
    G = (rng.standard_normal((hess_n, hess_n))
         + 1j * rng.standard_normal((hess_n, hess_n))) / np.sqrt(2 * hess_n)
    H_h = np.triu(G, -1) + 6.0 * np.eye(hess_n)
    lams_h = 0.5 * (rng.standard_normal(hess_k)
                    + 1j * rng.standard_normal(hess_k))
    B_h = rng.standard_normal((hess_k, hess_n)) \
        + 1j * rng.standard_normal((hess_k, hess_n))
    H = jnp.asarray(H_h, jnp.complex64)
    lams = jnp.asarray(lams_h, jnp.complex64)
    B = jnp.asarray(B_h, jnp.complex64)
    t_sweep = _median_time(
        lambda: jax.block_until_ready(solve_shifted_hessenberg(H, lams, B)), 3)
    W = np.asarray(solve_shifted_hessenberg(H, lams, B)).astype(np.complex128)
    H64 = np.asarray(H).astype(np.complex128)
    r0 = np.linalg.norm((H64 - lams_h[0] * np.eye(hess_n)) @ W[0] - B_h[0]) \
        / np.linalg.norm(B_h[0])
    _check(r0 <= 1e-3, f"hessenberg sweep residual {r0:.3e} (c64)")
    out["hess_sweep"] = {"n": hess_n, "k": hess_k, "median_s": t_sweep,
                         "cand0_rel_resid": float(r0)}
    return out


def phase_svd(m: int = 2048, n: int = 1024, rank: int = 16,
              tol: float = 1e-8, seed: int = 1) -> dict:
    """``maus_tpu.svd`` on an exactly rank-``rank`` operand with gapped σ's,
    every returned triplet checked two-sided in numpy c128."""
    import jax.numpy as jnp

    import maus_tpu

    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, rank))
                        + 1j * rng.standard_normal((m, rank)))
    V, _ = np.linalg.qr(rng.standard_normal((n, rank))
                        + 1j * rng.standard_normal((n, rank)))
    s = 0.8 ** np.arange(rank)
    A = jnp.asarray(((U * s) @ V.conj().T).astype(np.complex64))
    A_h = np.asarray(A).astype(np.complex128)
    t0 = time.perf_counter()
    rep = maus_tpu.svd(A, tol=tol, max_iterations=100,
                       num_candidates=2 * rank, target_solutions=rank)
    wall_s = time.perf_counter() - t0
    res = [float(np.linalg.norm(A_h @ v - sig * u)
                 + np.linalg.norm(A_h.conj().T @ u - sig * v))
           for sig, u, v in rep.solutions]
    at_tol = sum(r <= tol for r in res)
    _check(at_tol >= rank, f"svd: {at_tol} triplets at tol < {rank}")
    _check(max(res) <= tol, f"svd: worst numpy residual {max(res):.3e}")
    return {"shape": [m, n], "rank": rank, "count": rep.num_distinct,
            "iterations": rep.iterations, "converged": rep.converged,
            "wall_s_with_compile": wall_s, "max_numpy_resid": max(res)}


def phase_age(cycles: int = 5, cands: int = 20, seed: int = 0) -> dict:
    """The AGE reference-parity workload (benchmarks/age_probe.py)."""
    from maus_tpu.age import AgeConfig, GenesisEngine

    eng = GenesisEngine(AgeConfig(candidates_per_cycle=cands), seed=seed,
                        verbose=False)
    t0 = time.perf_counter()
    summaries = eng.run(cycles)
    wall_s = time.perf_counter() - t0
    best = max(s["best_fitness"] for s in summaries)
    _check(len(summaries) == cycles and np.isfinite(best),
           f"age: {len(summaries)} cycles, best fitness {best}")
    return {"cycles": cycles, "cands": cands, "wall_s_with_compile": wall_s,
            "best_fitness": float(best)}


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests() -> dict:
    """The GPU test tier, in this process (the only JAX process on the
    card)."""
    import os

    import pytest

    os.environ["MAUS_GPU_TESTS"] = "1"
    outcomes = _Outcomes()
    rc = pytest.main(["-m", "gpu", str(REPO / "tests" / "test_gpu.py"), "-q",
                      "-p", "no:cacheprovider"], plugins=[outcomes])
    _check(int(rc) == 0, f"GPU tier exit code {int(rc)}")
    _check(outcomes.counts.get("passed", 0) > 0
           and not outcomes.counts.get("skipped"),
           f"GPU tier outcomes {outcomes.counts}")
    return {"rc": int(rc), "outcomes": outcomes.counts}


def phase_mesh(n: int = 8192, cond: float = 1e6, n_devices: int = 4,
               tol: float = 1e-8, cands: int = 16) -> dict:
    """``solve(mesh=)`` on a (1, n_devices) mesh against the one-card
    ``solve`` of the same operand; eig/svd(mesh=) at the dry run's sizes,
    checked in numpy; then the dry run itself on the real devices."""
    import jax
    import jax.numpy as jnp

    import maus_tpu
    from __graft_entry__ import dryrun_multichip
    from bench import _device_problem
    from maus_tpu.parallel.dist_qr import stage_operands
    from maus_tpu.parallel.mesh import make_mesh

    devs = jax.devices()[:n_devices]
    _check(len(devs) == n_devices, f"{len(jax.devices())} devices")
    mesh = make_mesh(replica=1, model=n_devices, devices=devs)
    _check(set(mesh.devices.flat) == set(devs), "mesh built from devices[:n]")

    A, b = _device_problem(n, cond, jnp.complex64)
    A_h, b_h = np.asarray(A), np.asarray(b)
    A.delete()
    b.delete()
    A128, b128 = A_h.astype(np.complex128), b_h.astype(np.complex128)

    t0 = time.perf_counter()
    rep1 = maus_tpu.solve(A_h, b_h, tol=tol, num_candidates=cands)
    one_s = time.perf_counter() - t0
    x1 = rep1.best()[0]
    rel1 = _host_rel_residual(A128, x1, b128)
    del rep1
    gc.collect()

    staged = stage_operands(mesh, A_h, b_h)
    for arr in staged[:1] + staged[2:4]:            # A_dev, Are, Aim
        _check(arr.sharding.device_set == set(devs)
               and {s.data.shape for s in arr.addressable_shards}
               == {(n, n // n_devices)},
               f"operand column-sharded over devices[:{n_devices}]")
    # anything larger than one shard held by a single device would be a
    # full (or partial) operand copy left behind
    big_single = [a.shape for a in jax.live_arrays()
                  if a.size > n * n // n_devices
                  and len(a.sharding.device_set) == 1]
    _check(not big_single, f"operand copies on one device: {big_single}")
    del staged

    t0 = time.perf_counter()
    repm = maus_tpu.solve(A_h, b_h, tol=tol, num_candidates=cands, mesh=mesh)
    mesh_s = time.perf_counter() - t0
    xm = repm.solutions[0][0]
    relm = _host_rel_residual(A128, xm, b128)
    _check(rel1 <= tol and relm <= tol,
           f"residuals one-card {rel1:.3e}, mesh {relm:.3e} <= {tol:g}")
    # both solve the same system to backward error ≤ tol, so their forward
    # errors, and hence their difference, are bounded by ~κ·(rel1 + relm)
    diff = float(np.linalg.norm(xm - x1) / np.linalg.norm(x1))
    _check(diff <= 10 * cond * (rel1 + relm),
           f"mesh vs one-card solution differ by {diff:.3e}")

    m = n_devices
    rng = np.random.default_rng(7)
    n_e = 8 * m
    A_e = rng.standard_normal((n_e, n_e)) + 1j * rng.standard_normal((n_e, n_e))
    rep_e = maus_tpu.eig(A_e, tol=tol, max_iterations=20, num_candidates=4,
                         mesh=mesh)
    res_e = max(float(np.linalg.norm(A_e @ v - lam * v))
                for lam, v in rep_e.solutions)
    _check(rep_e.num_distinct >= 1 and res_e < 1e-6 * np.linalg.norm(A_e),
           f"mesh eig: {rep_e.num_distinct} pairs, worst residual {res_e:.3e}")
    m_sv, n_sv = 24, 8 * m
    U0, _ = np.linalg.qr(rng.standard_normal((m_sv, 3))
                         + 1j * rng.standard_normal((m_sv, 3)))
    V0, _ = np.linalg.qr(rng.standard_normal((n_sv, 3))
                         + 1j * rng.standard_normal((n_sv, 3)))
    s_true = np.array([5.0, 2.5, 1.0])
    A_sv = (U0 * s_true) @ V0.conj().T
    rep_s = maus_tpu.svd(A_sv, tol=tol, max_iterations=30, num_candidates=3,
                         mesh=mesh)
    res_s = max(float(np.linalg.norm(A_sv @ v - sig * u)
                      + np.linalg.norm(A_sv.conj().T @ u - sig * v))
                for sig, u, v in rep_s.solutions)
    _check(rep_s.num_distinct >= 2 and res_s < 1e-6 * s_true[0],
           f"mesh svd: {rep_s.num_distinct} triplets, worst {res_s:.3e}")

    t0 = time.perf_counter()
    dryrun_multichip(n_devices, real_devices=True)
    dry_s = time.perf_counter() - t0
    return {"n": n, "devices": [str(d) for d in devs],
            "one_card": {"wall_s_with_compile": one_s, "host_c128_rel": rel1},
            "mesh": {"wall_s_with_compile": mesh_s, "host_c128_rel": relm,
                     "iterations": repm.iterations},
            "solution_rel_diff": diff,
            "eig_mesh": {"n": n_e, "num_distinct": rep_e.num_distinct,
                         "max_resid": res_e},
            "svd_mesh": {"shape": [m_sv, n_sv],
                         "num_distinct": rep_s.num_distinct,
                         "max_resid": res_s},
            "dryrun_s": dry_s}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _run_phase(name: str, fn, failures: list) -> None:
    t0 = time.perf_counter()
    try:
        out = {"phase": name, "ok": True, **fn()}
    except Exception as e:          # report every phase, then fail the run
        failures.append(name)
        out = {"phase": name, "ok": False,
               "error": f"{type(e).__name__}: {e}"[:2000]}
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps(out, default=float), flush=True)
    gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh path only")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)   # split-f64 refinement
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke.py: needs a GPU; JAX's first device is on "
              f"{platform!r}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import bench

    # the card's name and power limit, as nvidia-smi gives them
    print(bench.nvidia_smi_name_power(), flush=True)
    failures: list = []
    if args.four:
        _run_phase("device", phase_device, failures)
        _run_phase("mesh", phase_mesh, failures)
    else:
        _run_phase("device", phase_device, failures)
        _run_phase("linear", phase_linear, failures)
        _run_phase("bench", lambda: bench.run(n=4096), failures)
        _run_phase("linear_16384", phase_linear_large, failures)
        _run_phase("residual", phase_residual, failures)
        _run_phase("eig", phase_eig, failures)
        _run_phase("svd", phase_svd, failures)
        _run_phase("age", phase_age, failures)
        _run_phase("gpu_tests", phase_gpu_tests, failures)
    if failures:
        print(f"chip_smoke.py: failed phases: {', '.join(failures)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": bench.device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
