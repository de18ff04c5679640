"""Fully on-device closed-loop rollouts.

Replaces the reference's host-side rollout loop
(``/root/reference/utils.py:254-290``), which crossed the device<->host
boundary and re-jitted on growing deque shapes every control step. Here an
entire episode is ONE ``lax.scan``:

    plan (iLQR on device) -> env.step (pure JAX) -> history update

with fixed-shape rolling history windows (zero-initialized, matching the
reference's zero-padded buffer start), so thousands of episodes batch with
``vmap``/``shard_map``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gan_mpc_tpu.data.normalizer import Normalizer


class EpisodeData(NamedTuple):
    states: jax.Array  # (T, obs) raw (unnormalized) observations
    actions: jax.Array  # (T, act)
    rewards: jax.Array  # (T,)
    qpos: jax.Array  # (T, nq) generalized positions (for replay/video)
    # generalized velocities: together with qpos these let a collector
    # RESTART the env from any visited state (DAgger corrective data)
    qvel: jax.Array = None


def episode_rollout(
    env,
    env_params,
    policy_fn: Callable,
    policy_params,
    normalizer: Normalizer,
    key: jax.Array,
    num_steps: int,
    history: int,
    action_noise: float = 0.0,
) -> EpisodeData:
    """Run one closed-loop episode entirely inside jit.

    ``policy_fn(policy_params, history_x, history_u) -> action`` where
    history_x is (history + 1, obs) NORMALIZED states (most recent last)
    and history_u is (history, act) — the contract of the reference's
    ``EvalMPC.get_optimal_action`` (``/root/reference/policy/eval.py:126``).

    ``action_noise`` adds clipped Gaussian exploration noise to the
    EXECUTED action (recorded as such). Use for on-policy dynamics-data
    collection: without it the policy's actions are a deterministic
    function of state, so the transitions carry no identifiable control
    signal and the dynamics model unlearns its action channel.
    """

    obs_size, act_size = env.obs_size, env.act_size
    k_reset, k_noise = jax.random.split(key)
    init_state = env.reset(env_params, k_reset)

    hist_x0 = jnp.zeros((history + 1, obs_size), dtype=jnp.float32)
    hist_u0 = jnp.zeros((history, act_size), dtype=jnp.float32)

    def step_fn(carry, k_step):
        env_state, hist_x, hist_u = carry
        obs = env.observe(env_params, env_state)
        xn = normalizer.normalize_state(obs)
        hist_x = jnp.roll(hist_x, -1, axis=0).at[-1].set(xn)
        u = policy_fn(policy_params, hist_x, hist_u)
        u = jnp.asarray(u, dtype=jnp.float32)
        if action_noise > 0.0:
            u = jnp.clip(
                u + action_noise * jax.random.normal(k_step, u.shape),
                -1.0,
                1.0,
            )
        hist_u = jnp.roll(hist_u, -1, axis=0).at[-1].set(
            normalizer.normalize_action(u)
        )
        qpos, qvel = env_state.qpos, env_state.qvel
        env_state, reward = env.step(env_params, env_state, u)
        return (env_state, hist_x, hist_u), (obs, u, reward, qpos, qvel)

    _, (states, actions, rewards, qpos, qvel) = jax.lax.scan(
        step_fn,
        (init_state, hist_x0, hist_u0),
        jax.random.split(k_noise, num_steps),
    )
    return EpisodeData(
        states=states, actions=actions, rewards=rewards, qpos=qpos, qvel=qvel
    )


def batched_rollout(
    env,
    env_params,
    policy_fn: Callable,
    policy_params,
    normalizer: Normalizer,
    key: jax.Array,
    num_steps: int,
    history: int,
    num_envs: int,
    action_noise: float = 0.0,
    env_keys=None,
) -> EpisodeData:
    """vmap N independent episodes (shared params, different reset keys).

    ``env_keys`` (num_envs, 2) supplies each episode's key explicitly —
    the sharded fused epoch splits keys GLOBALLY and hands each device
    its rows, so episode content is invariant to the mesh size."""
    keys = env_keys if env_keys is not None else jax.random.split(
        key, num_envs
    )
    return jax.vmap(
        lambda k: episode_rollout(
            env,
            env_params,
            policy_fn,
            policy_params,
            normalizer,
            k,
            num_steps,
            history,
            action_noise,
        )
    )(keys)


def batch_policy_rollout(
    env,
    env_params,
    batch_policy_fn: Callable,
    policy_params,
    normalizer: Normalizer,
    key: jax.Array,
    num_steps: int,
    history: int,
    num_envs: int,
    action_noise: float = 0.0,
    env_keys=None,
) -> EpisodeData:
    """Closed-loop rollouts driven by a BATCH policy: one scan over time
    for all envs, calling ``batch_policy_fn(params, hist_X (B,h+1,x),
    hist_U (B,h,u)) -> (B, act)`` — the batch-native planner path
    (``MPCPolicy.act_batch``), where the whole env batch enters one
    solver instance and the fused batch ops see real batches.
    """
    step_fn, init_carry, noise_keys = _batch_rollout_parts(
        env, env_params, batch_policy_fn, policy_params, normalizer,
        key, num_steps, history, num_envs, action_noise,
        env_keys=env_keys,
    )
    _, outs = jax.lax.scan(step_fn, init_carry, noise_keys)
    return _to_env_major(outs)


def _batch_rollout_parts(
    env, env_params, batch_policy_fn, policy_params, normalizer,
    key, num_steps, history, num_envs, action_noise, env_keys=None,
):
    """Shared machinery of the batch-of-envs rollouts: the per-step scan
    body, the initial carry, and the per-step noise keys.

    With ``env_keys`` (num_envs, 2), each env's reset AND exploration
    noise derive from its own key (noise per env per step via fold_in),
    so a mesh-sharded rollout of key rows reproduces the single-device
    episode content exactly. Default (env_keys=None) keeps the original
    layout: reset keys split from ``key``, one shared noise key per step.
    """
    obs_size, act_size = env.obs_size, env.act_size
    if env_keys is not None:
        per_env = jax.vmap(jax.random.split)(env_keys)  # (B, 2, 2)
        reset_keys, noise_base = per_env[:, 0], per_env[:, 1]
        scan_xs = jnp.arange(num_steps)
    else:
        k_reset, k_noise = jax.random.split(key)
        reset_keys = jax.random.split(k_reset, num_envs)
        noise_base = None
        scan_xs = jax.random.split(k_noise, num_steps)
    init_states = jax.vmap(lambda k: env.reset(env_params, k))(reset_keys)
    hist_x0 = jnp.zeros((num_envs, history + 1, obs_size), jnp.float32)
    hist_u0 = jnp.zeros((num_envs, history, act_size), jnp.float32)

    def step_fn(carry, x_step):
        env_states, hist_x, hist_u = carry
        obs = jax.vmap(lambda s: env.observe(env_params, s))(env_states)
        xn = normalizer.normalize_state(obs)
        hist_x = jnp.roll(hist_x, -1, axis=1).at[:, -1].set(xn)
        u = batch_policy_fn(policy_params, hist_x, hist_u)
        u = jnp.asarray(u, dtype=jnp.float32)
        if action_noise > 0.0:
            if noise_base is not None:
                noise = jax.vmap(
                    lambda k: jax.random.normal(
                        jax.random.fold_in(k, x_step), (act_size,)
                    )
                )(noise_base)
            else:
                noise = jax.random.normal(x_step, u.shape)
            u = jnp.clip(u + action_noise * noise, -1.0, 1.0)
        hist_u = jnp.roll(hist_u, -1, axis=1).at[:, -1].set(
            normalizer.normalize_action(u)
        )
        qpos, qvel = env_states.qpos, env_states.qvel
        env_states, reward = jax.vmap(
            lambda s, a: env.step(env_params, s, a)
        )(env_states, u)
        return (env_states, hist_x, hist_u), (obs, u, reward, qpos, qvel)

    init_carry = (init_states, hist_x0, hist_u0)
    return step_fn, init_carry, scan_xs


def _to_env_major(outs) -> EpisodeData:
    # time-major (T, B, ...) -> env-major (B, T, ...) like batched_rollout
    states, actions, rewards, qpos, qvel = outs
    f = lambda a: jnp.swapaxes(a, 0, 1)
    return EpisodeData(
        states=f(states), actions=f(actions), rewards=f(rewards),
        qpos=f(qpos), qvel=f(qvel),
    )


def chunked_batched_rollout(
    env,
    env_params,
    policy_fn: Callable,
    policy_params,
    normalizer: Normalizer,
    key: jax.Array,
    num_steps: int,
    history: int,
    num_envs: int,
    chunk_steps: int,
    action_noise: float = 0.0,
) -> EpisodeData:
    """Chunked long rollouts: ONE jitted program per
    ``chunk_steps``-step chunk, host-stepped between chunks.

    Bounds how long each device program runs (a runtime that kills
    long-running programs was the reason; none is known on the GPU)
    while keeping per-step dispatch amortized. Per-env
    ``policy_fn(params, hist_x (h+1,x), hist_u (h,u)) -> act`` like
    ``batched_rollout`` (vmapped over the env batch); bit-identical to
    ``batch_policy_rollout`` with the vmapped policy (same reset/noise
    key layout), and invariant to ``chunk_steps``.
    """
    def batch_policy_fn(p, hist_x, hist_u):
        return jax.vmap(lambda x, u: policy_fn(p, x, u))(hist_x, hist_u)

    step_fn, carry, noise_keys = _batch_rollout_parts(
        env, env_params, batch_policy_fn, policy_params, normalizer,
        key, num_steps, history, num_envs, action_noise,
    )
    chunk = jax.jit(lambda c, ks: jax.lax.scan(step_fn, c, ks))
    pieces = []
    for i in range(0, num_steps, chunk_steps):
        carry, outs = chunk(carry, noise_keys[i : i + chunk_steps])
        pieces.append(outs)
    outs = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *pieces
    )
    return _to_env_major(outs)


def policy_rollout(
    env,
    env_params,
    policy,
    policy_params,
    normalizer: Normalizer,
    key: jax.Array,
    num_steps: int,
    history: int,
    num_envs: int,
    action_noise: float = 0.0,
    env_keys=None,
) -> EpisodeData:
    """Rollout dispatcher: uses the batch-native planner path
    (``MPCPolicy.act_batch`` -> one solver for the whole env batch) when
    the policy supports it, vmapped per-env planning otherwise."""
    if getattr(policy, "batch_native", False):
        return batch_policy_rollout(
            env,
            env_params,
            policy.act_batch,
            policy_params,
            normalizer,
            key,
            num_steps=num_steps,
            history=history,
            num_envs=num_envs,
            action_noise=action_noise,
            env_keys=env_keys,
        )
    return batched_rollout(
        env,
        env_params,
        policy.act,
        policy_params,
        normalizer,
        key,
        num_steps=num_steps,
        history=history,
        num_envs=num_envs,
        action_noise=action_noise,
        env_keys=env_keys,
    )


def average_return(
    env,
    env_params,
    policy_fn,
    policy_params,
    normalizer,
    key,
    num_steps,
    history,
    num_runs,
) -> jax.Array:
    """Mean episode return over ``num_runs`` rollouts (the reference's
    ``avg_run_dm_policy`` metric, ``/root/reference/utils.py:293-306``)."""
    ep = batched_rollout(
        env,
        env_params,
        policy_fn,
        policy_params,
        normalizer,
        key,
        num_steps,
        history,
        max(num_runs, 1),
    )
    return jnp.mean(jnp.sum(ep.rewards, axis=-1))
