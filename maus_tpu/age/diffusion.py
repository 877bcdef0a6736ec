"""1-D diffusion simulation + spread fitness, batched over an expression
population.

Reference (K:64-152): per time step, a memory trace accumulates, the evolved
expression maps per-cell trace features to kernel weights (clipped sigmoid,
all-zero → uniform 0.5 fallback, K:49-58), the base 3-tap kernel is convolved
with the weights, normalized, and applied to the state; blow-up/die-out/NaN
aborts the run (K:98-112). Fitness is the normalized std-dev of the final
concentration (K:122-152).

Device rebuild: time is a ``lax.scan``; the expression evaluations for ALL cells and
ALL population members happen in one vectorized tape-interpreter call per step;
the convolutions are ``jnp.convolve``-equivalent ``lax.conv_general_dilated``
calls batched over the population. Failure is a carried boolean (branchless),
matching the reference's early-return as "failed stays failed".
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .interp import eval_tape


def _conv_same_batched(x: jax.Array, k: jax.Array) -> jax.Array:
    """np.convolve(x, k, mode='same') for batched x:(P,N), k:(P,M) or (M,)."""
    P, N = x.shape
    if k.ndim == 1:
        k = jnp.broadcast_to(k, (P, k.shape[0]))
    M = k.shape[1]
    # full correlation with flipped kernel == convolution
    kf = k[:, ::-1]
    lhs = x[:, None, :]                            # (P, C=1, N)
    rhs = kf[:, None, :]                           # (P, 1, M) → per-example filter
    # grouped conv: treat population as batch, one filter per example via vmap
    def one(xi, ki):
        return jax.lax.conv_general_dilated(
            xi[None, None, :], ki[None, None, :],
            window_strides=(1,), padding=[(M // 2, (M - 1) // 2)],
            dimension_numbers=("NCH", "OIH", "NCH"))[0, 0]
    return jax.vmap(one)(x, kf)


@partial(jax.jit, static_argnames=("n", "t"))
def run_diffusion_population(tapes: dict, n: int, t: int,
                             base_kernel: jax.Array
                             ) -> tuple[jax.Array, jax.Array]:
    """Run the T-step diffusion sim for a whole population of expressions.

    Returns ``(final_state, ok)``: (P, N) final concentration and (P,) success
    flags (False ⇔ the reference would have returned None, K:98-112).
    """
    P = tapes["opcode"].shape[0]
    center = n // 2
    state0 = jnp.zeros((P, n), jnp.float32).at[:, center].set(1.0)
    memory0 = jnp.zeros((P, n), jnp.float32)
    ok0 = jnp.ones((P,), bool)
    i_norm = (jnp.arange(n, dtype=jnp.float32) / n)[None, :].repeat(P, axis=0)

    def step(carry, t_step):
        state, memory, ok = carry
        memory = memory + state
        trace = jnp.tanh(memory) * 0.5 + 0.5                       # (P, N)

        # variables in tape order: m_i, m_c, delta_m, t_norm, i_norm (K:31-40)
        m_i = trace
        m_c = trace[:, center][:, None].repeat(n, axis=1)
        t_norm = jnp.full((P, n), t_step.astype(jnp.float32) / t)
        variables = jnp.stack([m_i, m_c, m_i - m_c, t_norm, i_norm], axis=1)

        val, valid = jax.vmap(
            lambda o, a, c, v: eval_tape(o, a, c, v))(
            tapes["opcode"], tapes["arg"], tapes["const"], variables)
        weights = jnp.where(
            valid, 1.0 / (1.0 + jnp.exp(-jnp.clip(val, -10.0, 10.0))), 0.0)
        # all-zero fallback → uniform 0.5 (K:56-58)
        dead = jnp.sum(weights, axis=1) < 1e-9 * n
        weights = jnp.where(dead[:, None], 0.5, weights)

        # effective kernel = convolve(base, weights) normalized (K:95-103)
        eff = _conv_same_batched(weights, base_kernel)
        ssum = jnp.sum(eff, axis=1)
        kernel_ok = jnp.abs(ssum) >= 1e-9
        eff = eff / jnp.where(kernel_ok, ssum, 1.0)[:, None]

        nxt = _conv_same_batched(state, eff)
        total = jnp.sum(nxt, axis=1)
        healthy = kernel_ok & jnp.all(jnp.isfinite(nxt), axis=1) & \
            (total >= 1e-7) & (total <= 1e7)
        ok = ok & healthy
        state = jnp.where(ok[:, None], nxt, state)   # failed members freeze
        return (state, memory, ok), None

    (state, _, ok), _ = jax.lax.scan(
        step, (state0, memory0, ok0), jnp.arange(1, t))
    return state, ok


@partial(jax.jit, static_argnames=("n", "t"))
def population_fitness(tapes: dict, n: int, t: int,
                       base_kernel: jax.Array) -> jax.Array:
    """Diffusion sim + spread fitness as ONE device program.

    The engine's stage-III hot path: composing the two calls eagerly costs a
    separate program dispatch for the sim plus ~10 eager-op round-trips for
    the fitness reduction, and every distinct population size is a fresh
    compile. Callers
    pad the population axis to a fixed bucket (age/engine.stage_III_test) so
    the reference workload compiles exactly once."""
    final, ok = run_diffusion_population(tapes, n, t, base_kernel)
    return spread_fitness(final, ok)


def spread_fitness(final_state: jax.Array, ok: jax.Array) -> jax.Array:
    """Normalized spatial std-dev of the final concentration (K:122-152):
    0 for failed/died-out members, else clamp(std/(N/2.5), 0, 1)."""
    P, n = final_state.shape
    total = jnp.sum(final_state, axis=1)
    alive = ok & (total > 1e-6)
    safe_total = jnp.where(total > 1e-9, total, 1.0)
    pos = jnp.arange(n, dtype=jnp.float32)[None, :]
    mean = jnp.sum(final_state * pos, axis=1) / safe_total
    var = jnp.sum(final_state * (pos - mean[:, None]) ** 2, axis=1) / safe_total
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    fit = jnp.clip(std / (n / 2.5), 0.0, 1.0)
    return jnp.where(alive, fit, 0.0)
