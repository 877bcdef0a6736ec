"""Island-model AGE (age/islands.py): sharded stage-III evaluation + ring
migration. The reference's AGE is strictly single-population (SURVEY.md §2.3);
this is the multi-device extension — semantics per island stay the reference's."""
import numpy as np
import pytest

import jax

from maus_tpu.age import AgeConfig, IslandAGE
from maus_tpu.parallel import mesh as mesh_mod

CFG = AgeConfig(max_cycles=4, candidates_per_cycle=10, diffusion_n=32,
                diffusion_t=20)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return mesh_mod.make_mesh(replica=8, model=1)


def test_mesh_independent_trajectory(mesh):
    """The sharded evaluation must not change the evolutionary trajectory —
    the mesh only changes WHERE candidates are evaluated."""
    a = IslandAGE(n_islands=3, config=CFG, seed=7, mesh=mesh, migrate_every=2)
    b = IslandAGE(n_islands=3, config=CFG, seed=7, mesh=None, migrate_every=2)
    oa = a.run(4)
    ob = b.run(4)
    assert [o["best_fitness"] for o in oa] == [o["best_fitness"] for o in ob]
    assert oa[-1]["library_total"] == ob[-1]["library_total"]


def test_islands_are_independent_streams():
    a = IslandAGE(n_islands=2, config=CFG, seed=1, migrate_every=0)
    out = a.run(2)
    s0, s1 = out[-1]["islands"]
    # different PRNG streams ⇒ different populations (overwhelmingly likely)
    assert s0["best_fitness"] != s1["best_fitness"] or \
        s0["library_size"] != s1["library_size"]


def test_migration_injects_neighbors_genomes():
    a = IslandAGE(n_islands=2, config=CFG, seed=2, migrate_every=1,
                  migrate_top_k=2)
    a.run(1)                              # cycle 1 ends with a migration
    # migrants staged for each island, sourced from its ring predecessor
    assert any(a._pending), "no migrants staged after a migration cycle"
    pool_sizes = [len(p) for p in a._pending]
    out2 = a.run_cycle()
    # injected migrants enlarge the weave pool in cycle 2 (which then stages
    # its own migration — migrate_every=1 — so _pending is refilled after)
    for size, s in zip(pool_sizes, out2["islands"]):
        assert s["candidates"] == CFG.candidates_per_cycle + size


def test_no_migration_when_disabled():
    a = IslandAGE(n_islands=2, config=CFG, seed=2, migrate_every=0)
    a.run(3)
    assert all(len(p) == 0 for p in a._pending)


def test_single_island_matches_reference_engine():
    """One island without migration is exactly the reference engine loop."""
    from maus_tpu.age import GenesisEngine

    isl = IslandAGE(n_islands=1, config=CFG, seed=11, migrate_every=0)
    ref = GenesisEngine(CFG, seed=11)
    oi = isl.run(3)
    orf = [ref.run_genesis_cycle() for _ in range(3)]
    assert [o["islands"][0]["best_fitness"] for o in oi] == \
        [o["best_fitness"] for o in orf]
