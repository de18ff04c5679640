"""shard_map training / collection steps.

Each device runs its shard of env+planner instances; parameters are
replicated; gradients and losses are ``pmean``-reduced over the mesh's
data-parallel axis (compiled to collectives between the devices). These are the
multi-chip equivalents of the single-device trainer inner loops in
``gan_mpc_tpu.training`` (and of the reference's vmapped single-device
batch steps, ``/root/reference/policy/base.py:122-128``).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gan_mpc_tpu.envs.rollout import batched_rollout
from gan_mpc_tpu.training.dynamics import multistep_prediction_loss


def make_dp_tp_dynamics_step(
    dynamics_model, opt, mesh: Mesh, gamma: float,
    dp_axis: str = "dp", tp_axis: str = "tp",
):
    """Hybrid data x tensor parallel dynamics update (GSPMD/pjit style).

    The batch shards over ``dp_axis`` and the MLP stack's hidden axes
    shard over ``tp_axis`` (``mesh.mlp_tensor_parallel_sharding``); XLA
    inserts the all-gather / reduce-scatter collectives, so gradients and
    optimizer state stay TP-sharded end to end — the scaling path for
    stacks wider than replication can hold (humanoid-scale ensembles).
    At this framework's default widths (<= 256 hidden) replication wins:
    two sub-microsecond GEMM halves cannot amortize the per-layer
    collective, which is why the single-chip quality configs do not
    enable it (measured note in BENCHMARKS.md). Numerics match the
    replicated step to fp tolerance (tests/test_parallel.py)."""
    from jax.sharding import NamedSharding

    from gan_mpc_tpu.parallel.mesh import mlp_tensor_parallel_sharding

    batch_sh = NamedSharding(mesh, P(dp_axis))
    repl = NamedSharding(mesh, P())

    def step(params, opt_state, X, U, Y, tf):
        params = jax.lax.with_sharding_constraint(
            params, mlp_tensor_parallel_sharding(params, mesh, tp_axis)
        )
        X, U, Y = (
            jax.lax.with_sharding_constraint(a, batch_sh) for a in (X, U, Y)
        )

        def loss_fn(params):
            losses = jax.vmap(
                lambda x, u, y: multistep_prediction_loss(
                    dynamics_model,
                    params["dynamics_params"],
                    x,
                    u,
                    y,
                    gamma,
                    tf,
                )
            )(X, U, Y)
            return jnp.mean(losses)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax.lax.with_sharding_constraint(loss, repl)

    return jax.jit(step)


def make_sharded_cost_step(
    policy, opt, mesh: Mesh, loss_fn: Callable, axis: str = "dp"
):
    """One data-parallel bilevel cost/generator update.

    (params, opt_state, X(batch,...), Y(batch,...)) -> (params, opt_state,
    loss); batch must divide the mesh size.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(params, opt_state, X, Y):
        loss, grads = policy.batched_loss_and_grad(
            params, X, loss_fn, (Y,)
        )
        loss = jax.lax.pmean(loss, axis)
        grads = jax.lax.pmean(grads, axis)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def make_sharded_dynamics_step(
    dynamics_model, opt, mesh: Mesh, gamma: float, axis: str = "dp"
):
    """One data-parallel multi-step dynamics update over (batch, seq, ·)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(params, opt_state, X, U, Y, tf):
        def loss_fn(params):
            losses = jax.vmap(
                lambda x, u, y: multistep_prediction_loss(
                    dynamics_model,
                    params["dynamics_params"],
                    x,
                    u,
                    y,
                    gamma,
                    tf,
                )
            )(X, U, Y)
            return jnp.mean(losses)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.lax.pmean(grads, axis)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def make_sharded_collect(
    env,
    env_params,
    policy_fn,
    normalizer,
    mesh: Mesh,
    num_steps: int,
    history: int,
    envs_per_device: int,
    axis: str = "dp",
):
    """Batched closed-loop episode collection sharded over the mesh:
    each device steps ``envs_per_device`` env+planner instances fully
    on-chip. (keys shape: (num_devices * envs_per_device, 2).)"""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def collect(params, keys):
        return jax.vmap(
            lambda k: _one_episode(params, k)
        )(keys)

    def _one_episode(params, key):
        from gan_mpc_tpu.envs.rollout import episode_rollout

        return episode_rollout(
            env,
            env_params,
            policy_fn,
            params,
            normalizer,
            key,
            num_steps,
            history,
        )

    return jax.jit(collect)


def make_sharded_critic_step(
    policy, opt, mesh: Mesh, axis: str = "dp"
):
    """One data-parallel critic (discriminator) BCE update over labelled
    (batch, seq, x) sequences."""
    from gan_mpc_tpu.policies.losses import critic_bce_loss

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(params, opt_state, seqs, labels):
        def loss_fn(params):
            losses = jax.vmap(
                lambda s, l: critic_bce_loss(
                    policy.critic_model, params["critic_params"], s, l
                )
            )(seqs, labels)
            return jnp.mean(losses)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.lax.pmean(grads, axis)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def ensemble_specs(tree, axis: str = "ep"):
    """Per-leaf PartitionSpecs: member-stacked arrays shard over ``axis``,
    scalar leaves (e.g. adam's step count) stay replicated."""
    return jax.tree_util.tree_map(
        lambda x: P(axis) if getattr(x, "ndim", 0) >= 1 else P(), tree
    )


def make_sharded_ensemble_step(
    ensemble,
    opt,
    mesh: Mesh,
    gamma: float,
    opt_state_template,
    axis: str = "ep",
):
    """One ensemble-parallel (EP) dynamics update: members shard across
    the mesh's ``axis``; every member trains on its own bootstrapped
    minibatch with zero cross-device communication (members independent;
    only the returned mean loss is pmean'd for logging).

    step(stacked_params, opt_state, Xm, Um, Ym, tf) with member-major
    data (E, B, seq, ·) -> (stacked_params, opt_state, mean_loss).
    ``opt_state_template`` fixes the per-leaf specs (scalar leaves like
    adam's count stay replicated).
    """
    ostate_specs = ensemble_specs(opt_state_template, axis)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), ostate_specs, P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), ostate_specs, P()),
        check_vma=False,
    )
    def step(stacked_params, opt_state, Xm, Um, Ym, tf):
        def member_loss(params, X, U, Y):
            losses = jax.vmap(
                lambda x, u, y: multistep_prediction_loss(
                    ensemble.member, params, x, u, y, gamma, tf
                )
            )(X, U, Y)
            return jnp.mean(losses)

        losses, grads = jax.vmap(
            jax.value_and_grad(member_loss), in_axes=(0, 0, 0, 0)
        )(stacked_params, Xm, Um, Ym)
        updates, opt_state = opt.update(grads, opt_state, stacked_params)
        stacked_params = optax.apply_updates(stacked_params, updates)
        return stacked_params, opt_state, jax.lax.pmean(
            jnp.mean(losses), axis
        )

    return jax.jit(step)
