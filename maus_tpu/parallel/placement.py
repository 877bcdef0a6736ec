"""Input placement helpers: put solver operands on a mesh with their canonical
shardings so the jitted evolve loop runs GSPMD-distributed without code changes.

The evolve loop itself is sharding-agnostic — XLA propagates the shardings below
through every batched op and inserts collectives (all-reduce for the masked
population statistics, all-gather where the factorization needs full rows). The
explicit shard_map kernels (``dist_qr``/``dist_hessenberg``/``dist_svd``/
``dist_refine``) take over where GSPMD cannot shard the factorization itself.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh

from ..core.types import Population
from . import mesh as mesh_mod


def place_operands(mesh: Mesh, A, b=None):
    """Row-shard A over the model axis; replicate b."""
    A = jax.device_put(A, mesh_mod.matrix_sharding(mesh))
    if b is not None:
        b = jax.device_put(b, mesh_mod.vector_sharding(mesh))
    return A, b


def place_population(mesh: Mesh, pop: Population) -> Population:
    """Shard the candidate axis over replica; vectors additionally over model."""
    kv = mesh_mod.population_matrix_sharding(mesh)
    ks = mesh_mod.population_vector_sharding(mesh)

    def put(x, shard):
        return None if x is None else jax.device_put(x, shard)

    return Population(
        v=put(pop.v, kv), u=put(pop.u, kv),
        lam=put(pop.lam, ks), weight=put(pop.weight, ks),
        alpha=put(pop.alpha, ks), stuck=put(pop.stuck, ks),
        status=put(pop.status, ks), residual=put(pop.residual, ks),
        prev_residual=put(pop.prev_residual, ks),
        psi_level=put(pop.psi_level, ks),
        keys=put(pop.keys, mesh_mod.population_vector_sharding(mesh)),
        retire_count=put(pop.retire_count, ks))
