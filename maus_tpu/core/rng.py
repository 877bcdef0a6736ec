"""Per-candidate PRNG stream management.

The reference uses the global ``np.random`` stream (AMS:130-143, AMS:49) which makes
runs irreproducible. Here every candidate slot carries its own counter-based key
(stored as a raw ``(K, 2) uint32`` array inside the :class:`~maus_tpu.core.types.
Population` pytree) so re-initialization of one slot never perturbs the others and
whole runs replay bit-exactly — the determinism story called for in SURVEY.md §5.2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def make_candidate_keys(key: jax.Array, capacity: int) -> jax.Array:
    """Split a base key into one raw ``(capacity, 2) uint32`` key per slot."""
    keys = jax.random.split(key, capacity)
    return jax.random.key_data(keys) if jnp.issubdtype(keys.dtype, jax.dtypes.prng_key) \
        else keys


def fold_in_batch(keys: jax.Array, data: int | jax.Array) -> jax.Array:
    """``jax.random.fold_in`` over a batch of raw uint32 keys."""
    def one(k):
        return jax.random.key_data(jax.random.fold_in(jax.random.wrap_key_data(k), data))
    return jax.vmap(one)(keys)


def split_batch(keys: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Split each raw key into (next_key, use_key)."""
    def one(k):
        a, b = jax.random.split(jax.random.wrap_key_data(k))
        return jax.random.key_data(a), jax.random.key_data(b)
    return jax.vmap(one)(keys)


def normal_like_batch(keys: jax.Array, shape: tuple, dtype) -> jax.Array:
    """Zero-mean unit-variance (complex) normals, one independent draw per key.

    Zero-mean init is a deliberate fix over the reference's ``U[0,1]+U[0,1]j`` init
    (AMS:130): non-zero-mean vectors all overlap the same low-frequency eigenvectors
    and collapse population diversity (SURVEY.md §0.1).
    """
    def one(k):
        kk = jax.random.wrap_key_data(k)
        if jnp.issubdtype(dtype, jnp.complexfloating):
            rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
            kr, ki = jax.random.split(kk)
            re = jax.random.normal(kr, shape, rdt)
            im = jax.random.normal(ki, shape, rdt)
            # lax.complex builds the target dtype directly (no c128 detour)
            return jax.lax.complex(re, im).astype(dtype) / jnp.sqrt(2).astype(rdt)
        return jax.random.normal(kk, shape, dtype)
    return jax.vmap(one)(keys)
