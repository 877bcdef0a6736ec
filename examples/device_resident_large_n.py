"""Device-resident large-N solve: the operand never touches the host.

The realistic production shape: a matrix PRODUCED by an upstream JAX
computation (here a κ-controlled synthetic, in practice an assembled system)
is solved in place, with no copy of it through host memory.

`MausSolver` / `maus_tpu.solve` accept `jax.Array` operands directly:
diagnosis (structure, density, condition, SVD rank) runs on device, the rhs
stays on device, and for complex64/float32 inputs the refinement planes are
widened on device from the operand itself.

Run (any backend; sized for a quick demo — raise --n on a GPU):

    python examples/device_resident_large_n.py --cpu --n 512
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cond", type=float, default=1e6)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import maus_tpu
    from maus_tpu.core import backend
    from maus_tpu.core.types import ProblemType
    from maus_tpu.solver import api as api_mod

    if not backend.is_accelerator():
        # the device-staging gate keys on the accelerator backends (on CPU the
        # host path is equivalent); force it so the demo exercises the same
        # code path everywhere
        api_mod._device_staging_ok = lambda: True

    n = args.n

    # --- operand assembled ON DEVICE (stand-in for an upstream pipeline) ---
    @jax.jit
    def make_system(key):
        k1, k2, k3 = jax.random.split(key, 3)
        rdt = jnp.float32

        def qhaar(k):
            ka, kb = jax.random.split(k)
            g = jax.lax.complex(jax.random.normal(ka, (n, n), rdt),
                                jax.random.normal(kb, (n, n), rdt))
            q, r = jnp.linalg.qr(g)
            d = jnp.diagonal(r)
            return q * (d / jnp.abs(d))[None, :]

        s = jnp.logspace(0.0, -jnp.log10(jnp.float32(args.cond)), n,
                         dtype=rdt).astype(jnp.complex64)
        A = (qhaar(k1) * s[None, :]) @ jnp.conj(qhaar(k2)).T
        b = jax.lax.complex(jax.random.normal(k3, (n,), rdt),
                            jax.random.normal(jax.random.fold_in(k3, 1),
                                              (n,), rdt))
        return A, b

    A, b = make_system(jax.random.PRNGKey(0))
    jax.block_until_ready(A)
    print(f"operand on device: {A.shape} {A.dtype} (never fetched)")

    t0 = time.perf_counter()
    solver = maus_tpu.MausSolver(A, ProblemType.SOLVE_LINEAR_SYSTEM,
                                 b_vector=b, initial_num_candidates=12)
    print(f"constructed in {time.perf_counter()-t0:.2f}s — host copy: "
          f"{solver.A_host}, host rhs: {solver.b_host}, "
          f"host_refactor: {solver.config.host_refactor}")
    rep = solver.evolve(60)
    print(f"converged={rep.converged} iters={rep.iterations} "
          f"residual={rep.residuals[0]:.2e} "
          f"total {time.perf_counter()-t0:.2f}s")


if __name__ == "__main__":
    main()
