"""Device mesh construction — the framework's distribution backbone (SURVEY.md §5.8).

The reference has no distributed story at all (§2.3); this design's two
parallel axes come from its *latent* parallelism:

* ``replica`` — the candidate-population axis (the reference's per-candidate Python
  loop, AMS:574-576): embarrassingly parallel, sharded K-way.
* ``model`` — the matrix dimension (large-N scaling): operands row-sharded so
  matvec/GEMM work and A's memory footprint split across devices, with XLA
  inserting the collectives (NCCL over NVLink on GPUs, where every card
  reaches every other at the same rate).

Everything downstream is mesh-agnostic: on one device the same code runs with a
trivial 1×1 mesh.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPLICA_AXIS = "replica"
MODEL_AXIS = "model"


def make_mesh(replica: int = 1, model: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (replica, model) mesh over the available devices.

    ``model=None`` uses all remaining devices for the model axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if model is None:
        if n % replica != 0:
            raise ValueError(f"{n} devices not divisible by replica={replica}")
        model = n // replica
    if replica * model > n:
        raise ValueError(f"mesh {replica}x{model} needs {replica * model} devices, "
                         f"have {n}")
    arr = np.asarray(devices[: replica * model]).reshape(replica, model)
    return Mesh(arr, (REPLICA_AXIS, MODEL_AXIS))


def single_device_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                (REPLICA_AXIS, MODEL_AXIS))


# ---------------------------------------------------------------------------
# Canonical shardings for the solver's operands
# ---------------------------------------------------------------------------

def matrix_sharding(mesh: Mesh) -> NamedSharding:
    """A row-sharded over the model axis (the §5.7 'sequence-parallel' analogue)."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def vector_sharding(mesh: Mesh) -> NamedSharding:
    """b / x replicated (small relative to A; avoids gather churn in solves)."""
    return NamedSharding(mesh, P())


def population_matrix_sharding(mesh: Mesh) -> NamedSharding:
    """(K, N) candidate blocks: K over replica, N over model."""
    return NamedSharding(mesh, P(REPLICA_AXIS, MODEL_AXIS))


def population_vector_sharding(mesh: Mesh) -> NamedSharding:
    """(K,) per-candidate scalars over replica."""
    return NamedSharding(mesh, P(REPLICA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host/multi-slice initialization (SURVEY.md §5.8): thin wrapper over
    ``jax.distributed.initialize`` so callers never import jax.distributed
    directly. No-ops when already initialized or running single-process.

    On multi-host deployments, build the mesh afterwards with
    ``make_mesh(replica=n_hosts, model=devices_per_host)`` so the model axis
    (heavy matvec collectives) stays within a host's NVLink domain and only
    the replica-axis reductions (scalar landscape statistics) cross the
    network.
    """
    import jax

    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # single-process or already initialized
