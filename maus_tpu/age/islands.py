"""Island-model AGE: independent genesis engines, ONE mesh-sharded device
evaluation, ring migration.

The reference's AGE is a single sequential population (KAIROSAGE K:326-509 —
no parallelism of any kind, SURVEY.md §2.3). On the device the expensive stage (III:
the T-step diffusion simulation per candidate, K:405-461) is already a batched
device program (`age/diffusion.py`); this driver scales it across a device
mesh the idiomatic way:

* M islands each run the reference's exact cycle semantics (stages I/II/IV on
  host, per-island PRNG streams, per-island novelty archives);
* every cycle, ALL islands' candidates are compiled to one stacked tape batch
  and evaluated as ONE device program with the candidate axis sharded over the
  mesh's ``replica`` axis (GSPMD — the population is the data-parallel axis,
  same mapping as the MAUS candidate batch, SURVEY.md §2.3);
* every ``migrate_every`` cycles the top-k archived genomes of each island are
  injected into the next island's weave pool (ring topology) — the classic
  island-model migration that the single-population reference cannot express.

Results are deterministic and mesh-independent: the sharded evaluation
computes the same fitness values as a single-device run (tested), so the mesh
only changes WHERE candidates are evaluated, never the evolutionary
trajectory.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from . import diffusion
from .engine import AgeConfig, GenesisEngine, Genome
from .tape import compile_tree, stack_tapes


class IslandAGE:
    """M islands × the reference's genesis cycle, with a shared sharded
    stage-III evaluation and ring migration."""

    def __init__(self, n_islands: int = 4, config: Optional[AgeConfig] = None,
                 seed: int = 0, mesh=None, migrate_every: int = 5,
                 migrate_top_k: int = 2, verbose: bool = False):
        if n_islands < 1:
            raise ValueError("need at least one island")
        self.conf = config or AgeConfig()
        self.engines = [GenesisEngine(self.conf, seed=seed + 1009 * i,
                                      verbose=False)
                        for i in range(n_islands)]
        self.mesh = mesh
        self.migrate_every = migrate_every
        self.migrate_top_k = migrate_top_k
        self.verbose = verbose
        self.cycle = 0
        self._pending: List[List[Genome]] = [[] for _ in range(n_islands)]
        self._base_kernel = jnp.asarray(np.asarray(self.conf.base_kernel,
                                                   np.float32))

    # -- sharded stage-III evaluation ---------------------------------------
    def _eval_fitness(self, genomes: List[Genome]) -> np.ndarray:
        c = self.conf
        if not genomes:
            return np.zeros((0,), np.float32)
        tapes = stack_tapes([compile_tree(g.tree, c.variables)
                             for g in genomes])
        P = tapes["opcode"].shape[0]
        pad = 0
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as Pspec

            from ..parallel.mesh import REPLICA_AXIS

            r = self.mesh.shape.get(REPLICA_AXIS, 1)
            pad = (-P) % max(r, 1)
            if pad:
                tapes = {k: np.concatenate([v, v[:1].repeat(pad, axis=0)])
                         for k, v in tapes.items()}
            shard = NamedSharding(self.mesh, Pspec(REPLICA_AXIS))
            tapes = {k: jax.device_put(jnp.asarray(v), shard)
                     for k, v in tapes.items()}
        else:
            tapes = {k: jnp.asarray(v) for k, v in tapes.items()}
        final, ok = diffusion.run_diffusion_population(
            tapes, c.diffusion_n, c.diffusion_t, self._base_kernel)
        fit = np.asarray(diffusion.spread_fitness(final, ok))
        return fit[:P]

    # -- migration (ring) ----------------------------------------------------
    def _migrate(self):
        k = self.migrate_top_k
        n = len(self.engines)
        for i, e in enumerate(self.engines):
            ranked = sorted(e.harmonic_library,
                            key=lambda g: g.stability + g.integrity + g.novelty,
                            reverse=True)[:k]
            dest = (i + 1) % n
            # fresh Genome wrappers: island-local scores are re-derived on the
            # destination island (its own stage III re-evaluates them)
            self._pending[dest].extend(
                Genome(tree=g.tree,
                       rules_version=self.engines[dest].rules_version)
                for g in ranked)

    # -- one synchronized cycle across all islands --------------------------
    def run_cycle(self) -> dict:
        self.cycle += 1
        per_island: List[List[Genome]] = []
        for i, e in enumerate(self.engines):
            e.cycle_count += 1
            e.stage_I_ingest_primitives()
            cands = e.stage_II_weave()
            if self._pending[i]:
                for g in self._pending[i]:
                    g.novelty = e.rng.uniform(0.2, 0.8)
                cands = self._pending[i] + cands
                self._pending[i] = []
            per_island.append(cands)

        flat = [g for isl in per_island for g in isl]
        fitness = self._eval_fitness(flat)

        summaries = []
        ofs = 0
        for e, cands in zip(self.engines, per_island):
            fit = fitness[ofs:ofs + len(cands)]
            ofs += len(cands)
            summaries.append(e.complete_cycle(cands, fitness=fit))

        if self.migrate_every and self.cycle % self.migrate_every == 0:
            self._migrate()

        best = max((s["best_fitness"] for s in summaries), default=0.0)
        out = {
            "cycle": self.cycle,
            "islands": summaries,
            "best_fitness": best,
            "library_total": sum(len(e.harmonic_library)
                                 for e in self.engines),
        }
        if self.verbose:
            print(f"ISLANDS cycle {self.cycle}: best={best:.3f} "
                  f"lib_total={out['library_total']}")
        return out

    def run(self, cycles: Optional[int] = None) -> List[dict]:
        return [self.run_cycle()
                for _ in range(cycles or self.conf.max_cycles)]
