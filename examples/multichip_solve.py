"""Multi-chip example: solve a row-sharded system with the population sharded
data-parallel over the replica axis.

Run on any host with 8 visible devices (real chips or virtual):

    JAX_PLATFORMS=cpu python examples/multichip_solve.py      # 8 virtual CPUs

The same code runs unchanged on a multi-GPU host — only `make_mesh` arguments
change.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("MAUS_EXAMPLE_BACKEND") != "native":
    # default: 8 virtual CPU devices, switched BEFORE any backend touch —
    # probing a pre-registered accelerator backend first blocks indefinitely
    # when its transport is down. Set MAUS_EXAMPLE_BACKEND=native on a real
    # multi-chip slice to run unchanged there.
    import jax.extend.backend as _jeb

    _jeb.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np

import maus_tpu
from maus_tpu.parallel import mesh as mesh_mod
from maus_tpu.parallel import placement
from maus_tpu.problems import generators as gen
from maus_tpu.solver import evolve as ev


def main():
    # 2-way data parallel over candidates × 4-way tensor parallel over rows
    mesh = mesh_mod.make_mesh(replica=2, model=4)
    print(f"mesh: {dict(mesh.shape)} over {len(jax.devices())} devices")

    A_host, b_host = gen.well_conditioned_system(256, seed=0)
    s = maus_tpu.MausSolver(A_host, maus_tpu.ProblemType.SOLVE_LINEAR_SYSTEM,
                            b_vector=b_host, initial_num_candidates=16)

    A, b = placement.place_operands(mesh, s.A, s.b)
    carry, _ = ev.evolve_while(s.config, s.knowledge, A, b, s._key,
                               max_iterations=40, target_solutions=1)

    conv = np.asarray(carry.pop.status) == int(maus_tpu.CandidateStatus.CONVERGED)
    x = np.asarray(carry.pop.v)[conv][0]
    rel = np.linalg.norm(A_host @ x - b_host) / np.linalg.norm(b_host)
    print(f"converged candidates: {conv.sum()}/{len(conv)}; "
          f"relative residual {rel:.2e}")


if __name__ == "__main__":
    main()
