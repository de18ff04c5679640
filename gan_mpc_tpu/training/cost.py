"""Bilevel cost trainer.

Capability parity with ``/root/reference/norm/cost_trainer.py``: optimize
the cost parameters (and sigmoid-squashed MPC weights) so that planning
with them reproduces expert futures. Each update is a ``lax.scan`` over
minibatches of (history window, desired future window); the gradient goes
THROUGH the planner via the implicit custom VJP. After each train() call,
parameters are Polyak-blended back toward their pre-update values
(factor 0.9, ``cost_trainer.py:88-92``) — a trust-region-like damping the
reference relies on for stability.

The same function trains the GAN generator (outer loss = critic score,
``/root/reference/gan/js_policy.py:60-74``) — pass ``loss_fn=
gan_generator_loss`` and ``per_batch_args=False``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax

from gan_mpc_tpu.data.windows import minibatch_indices
from gan_mpc_tpu.training.masking import polyak_blend


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 7))
def _update_scan(
    policy, opt, loss_fn, params, opt_state, perm, dataset, has_targets
):
    X = dataset[0]
    Y = dataset[1] if has_targets else None

    def body(carry, p):
        params, opt_state = carry
        loss_args = (Y[p],) if has_targets else ()
        loss, grads = policy.batched_loss_and_grad(
            params, X[p], loss_fn, loss_args
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    (params, opt_state), losses = jax.lax.scan(body, (params, opt_state), perm)
    return params, opt_state, jnp.mean(losses)


_MAX_EVAL_WINDOWS = 256


def evaluate_cost_loss(
    policy, loss_fn, params, dataset, has_targets=True, eval_windows=None
):
    """Planning loss on a held-out set (no grads). Capped at
    ``eval_windows`` (default ``_MAX_EVAL_WINDOWS``) — each one is a full
    planner solve; the reference's evaluate-the-whole-test-set-each-update
    habit (norm/cost_trainer.py:44-48) dominates wall-clock at realistic
    dataset sizes, and very large plan batches at long horizons need
    device memory in proportion."""
    cap = _MAX_EVAL_WINDOWS if eval_windows is None else eval_windows
    X = dataset[0][:cap]
    Y = dataset[1][:cap] if has_targets else None

    def single(history_x, *args):
        zeros_u = jnp.zeros(
            (history_x.shape[0] - 1, policy.expert_model.u_size), jnp.float32
        )
        sol = policy.plan(params, history_x, zeros_u, warm_start_carry=False)
        return loss_fn(policy, sol, params, *args)

    args = (Y,) if has_targets else ()
    in_axes = (0,) * (1 + len(args))
    return float(jnp.mean(jax.vmap(single, in_axes=in_axes)(X, *args)))


def train_cost(
    policy,
    optimizer,
    params: dict,
    opt_state,
    train_data,
    test_data,
    loss_fn: Callable,
    num_updates: int,
    batch_size: int,
    polyak_factor: float,
    key: jax.Array,
    has_targets: bool = True,
    eval_test: bool = True,
    eval_windows: int = None,
    max_steps_per_update: int = None,
):
    """Returns (params, opt_state, train_losses, test_losses)."""
    prev_params = params
    datasize = train_data[0].shape[0]
    steps = max(datasize // batch_size, 1)
    if max_steps_per_update is not None:
        # one scanned program of `steps` bilevel solves; configs can
        # bound how long that program runs.
        steps = min(steps, max_steps_per_update)
    train_losses, test_losses = [], []
    for _ in range(num_updates):
        key, sub = jax.random.split(key)
        perm = minibatch_indices(sub, datasize, steps, batch_size)
        params, opt_state, loss = _update_scan(
            policy,
            optimizer,
            loss_fn,
            params,
            opt_state,
            perm,
            train_data,
            has_targets,
        )
        train_losses.append(float(loss))
        if eval_test:
            test_losses.append(
                evaluate_cost_loss(
                    policy, loss_fn, params, test_data, has_targets,
                    eval_windows=eval_windows,
                )
            )
    params = polyak_blend(prev_params, params, polyak_factor)
    return params, opt_state, train_losses, test_losses
