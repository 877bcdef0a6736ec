"""Distributed eig + SVD example: operands column-sharded over the model axis
so matrices larger than one device's memory iterate in place.

Run on any host with 8 visible devices (real chips or virtual):

    JAX_PLATFORMS=cpu python examples/distributed_eig_svd.py   # 8 virtual CPUs

The same code runs unchanged on a multi-GPU host
(MAUS_EXAMPLE_BACKEND=native) — only `make_mesh` arguments change. All three problem classes have distributed paths (linear →
``maus_tpu.solve(A, b, mesh=)`` / ``solve_distributed``; eig and SVD below).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("MAUS_EXAMPLE_BACKEND") != "native":
    # default: 8 virtual CPU devices, switched before any backend touch.
    # Set MAUS_EXAMPLE_BACKEND=native on a multi-GPU host to run there.
    import jax.extend.backend as _jeb

    _jeb.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

jax.config.update("jax_enable_x64", True)   # c128 on CPU, f64 planes on GPU

import numpy as np

import maus_tpu
from maus_tpu.core import backend
from maus_tpu.parallel import mesh as mesh_mod


def main():
    mesh = mesh_mod.make_mesh(replica=1, model=8)
    print(f"mesh: {dict(mesh.shape)} over {len(jax.devices())} devices")
    rng = np.random.default_rng(0)
    # achievable tolerance is set by the COMPUTE dtype (c64 on the GPU even
    # with x64 on)
    full_prec = backend.default_complex_dtype() == np.complex128
    tol = 1e-8 if full_prec else 1e-5

    # --- eig: column-sharded Hessenberg reduction + sharded shifted solves --
    n = 64
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    rep = maus_tpu.eig(A, tol=tol, num_candidates=12, max_iterations=40,
                       mesh=mesh)
    worst = max((np.linalg.norm(A @ v - lam * v)
                 for lam, v in rep.solutions), default=float("nan"))
    print(f"eig: {rep.num_distinct} distinct eigenpairs, "
          f"worst residual {worst:.2e}")

    # --- SVD: sharded block subspace iteration (CholeskyQR2 + Ritz) --------
    m = 96
    U0, _ = np.linalg.qr(rng.standard_normal((m, 4))
                         + 1j * rng.standard_normal((m, 4)))
    V0, _ = np.linalg.qr(rng.standard_normal((n, 4))
                         + 1j * rng.standard_normal((n, 4)))
    B = (U0 * np.array([4.0, 2.0, 1.0, 0.5])) @ V0.conj().T
    rep = maus_tpu.svd(B, tol=tol, mesh=mesh)
    print(f"svd: {rep.num_distinct}/{rep.target_solutions} triplets, "
          f"sigmas {[round(s[0], 6) for s in rep.solutions]}")
    for sig, u, v in rep.solutions:
        r = (np.linalg.norm(B @ v - sig * u)
             + np.linalg.norm(B.conj().T @ u - sig * v))
        assert r < tol, r
    print(f"all triplet residuals < {tol:g}")


if __name__ == "__main__":
    main()
