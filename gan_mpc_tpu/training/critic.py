"""GAN critic (discriminator) trainer.

Capability parity with ``/root/reference/gan/critic_trainer.py``: every
epoch, build a fresh labelled dataset by PLANNING on expert histories with
the current generator (planner) — expert futures labelled +1, planner
futures labelled -1 — then run binary-cross-entropy updates via a scanned
minibatch loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax

from gan_mpc_tpu.data.windows import minibatch_indices
from gan_mpc_tpu.policies.losses import critic_bce_loss


@functools.partial(jax.jit, static_argnums=(0,))
def build_critic_dataset(policy, params, X, Y, key):
    """(histories X, expert futures Y) -> shuffled (xseq, label) pairs.

    The planner runs under vmap over every history — the batched-planning
    fan-out (``/root/reference/gan/critic_trainer.py:12-38``).
    """

    def predict(history_x):
        zeros_u = jnp.zeros(
            (history_x.shape[0] - 1, policy.expert_model.u_size), jnp.float32
        )
        sol = policy.plan(params, history_x, zeros_u, warm_start_carry=False)
        return policy.planned_states(sol)

    pred_Y = jax.vmap(predict)(X)
    n = Y.shape[0]
    seqs = jnp.concatenate([Y, pred_Y], axis=0)
    labels = jnp.concatenate(
        [jnp.ones((n,), jnp.float32), -jnp.ones((n,), jnp.float32)]
    )
    perm = jax.random.permutation(key, 2 * n)
    return seqs[perm], labels[perm]


@functools.partial(jax.jit, static_argnums=(0, 1))
def _update_scan(critic_model, opt, params, opt_state, perm, seqs, labels):
    def body(carry, p):
        params, opt_state = carry

        def loss_fn(params):
            losses = jax.vmap(
                lambda s, l: critic_bce_loss(
                    critic_model, params["critic_params"], s, l
                )
            )(seqs[p], labels[p])
            return jnp.mean(losses)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    (params, opt_state), losses = jax.lax.scan(body, (params, opt_state), perm)
    return params, opt_state, jnp.mean(losses)


def evaluate_critic_loss(critic_model, params, seqs, labels) -> float:
    losses = jax.vmap(
        lambda s, l: critic_bce_loss(
            critic_model, params["critic_params"], s, l
        )
    )(seqs, labels)
    return float(jnp.mean(losses))


def train_critic(
    policy,
    optimizer,
    params: dict,
    opt_state,
    true_train_data,
    true_test_data,
    num_updates: int,
    batch_size: int,
    key: jax.Array,
    plan_batch: int = 256,
):
    """Returns (params, opt_state, train_losses, test_losses).

    ``plan_batch`` caps the batched-planning fan-out on both the train
    and held-out dataset builds — each window is a full iLQR solve, and
    very large plan batches at long horizons need device memory in
    proportion; a fresh random subset is drawn per call."""
    key, k_train, k_test, k_sub = jax.random.split(key, 4)
    Xtr, Ytr = true_train_data[0], true_train_data[1]
    if Xtr.shape[0] > plan_batch:
        idx = jax.random.choice(
            k_sub, Xtr.shape[0], shape=(plan_batch,), replace=False
        )
        Xtr, Ytr = Xtr[idx], Ytr[idx]
    seqs, labels = build_critic_dataset(policy, params, Xtr, Ytr, k_train)
    # cap the held-out planning fan-out (each window is a full solve)
    test_seqs, test_labels = build_critic_dataset(
        policy,
        params,
        true_test_data[0][:plan_batch],
        true_test_data[1][:plan_batch],
        k_test,
    )
    datasize = seqs.shape[0]
    steps = max(datasize // batch_size, 1)
    train_losses, test_losses = [], []
    for _ in range(num_updates):
        key, sub = jax.random.split(key)
        perm = minibatch_indices(sub, datasize, steps, batch_size)
        params, opt_state, loss = _update_scan(
            policy.critic_model, optimizer, params, opt_state, perm, seqs, labels
        )
        train_losses.append(float(loss))
        test_losses.append(
            evaluate_critic_loss(
                policy.critic_model, params, test_seqs, test_labels
            )
        )
    return params, opt_state, train_losses, test_losses
