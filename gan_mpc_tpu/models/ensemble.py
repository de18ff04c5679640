"""Ensemble dynamics models (the EP axis of the humanoid-scale config).

BASELINE.json configs[4]: "long-horizon (H>=50) MPC with ensemble dynamics
models sharded across a full device mesh". An ensemble of E independent
dynamics nets is held as stacked parameters (leading axis E); the planner
consumes the ensemble MEAN prediction (smooth, differentiable), while
training updates every member on bootstrapped minibatches. The ensemble
axis maps onto a mesh "ep" axis: members shard across devices, member
updates are fully local (no collectives), and plan-time mean prediction is
one ``psum`` over ep.

Drop-in compatible with ``LearnedDynamics`` everywhere the policy/planner
touches dynamics (init / __call__ / zero_carry / warm_carry), so
``MPCPolicy`` works unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.dynamics import LearnedDynamics


class EnsembleDynamics:
    def __init__(self, net, num_members: int):
        self.member = LearnedDynamics(net)
        self.net = net
        self.num_members = num_members
        self.x_size = net.x_size
        self.carry_size = net.carry_size

    def init(self, key: jax.Array, u_size: int):
        keys = jax.random.split(key, self.num_members)
        return jax.vmap(lambda k: self.member.init(k, u_size))(keys)

    def zero_carry(self) -> jax.Array:
        return self.member.zero_carry()

    @property
    def is_batch_native(self) -> bool:
        # the batch-native time-major solver path expects a single
        # dynamics net's fused batch ops; the ensemble plans through the
        # vmapped per-instance path
        return False

    def member_predict(self, xc, u, t, stacked_params):
        """(E, ...) per-member next states."""
        return jax.vmap(
            lambda p: self.member(xc, u, t, p)
        )(stacked_params)

    def __call__(self, xc, u, t, stacked_params):
        """Ensemble-mean prediction (the planner's dynamics)."""
        return jnp.mean(self.member_predict(xc, u, t, stacked_params), axis=0)

    def warm_carry(self, stacked_params, history_x, history_u):
        if self.carry_size == 0:
            return self.zero_carry()

        def step(carry, xu):
            x, u = xu
            xc = jnp.concatenate([x, carry], axis=-1)
            next_xc = self(xc, u, 0, stacked_params)
            return next_xc[self.x_size :], None

        carry, _ = jax.lax.scan(
            step, self.zero_carry(), (history_x, history_u)
        )
        return carry

    def disagreement(self, xc, u, t, stacked_params) -> jax.Array:
        """Per-dimension std across members — the standard epistemic-
        uncertainty signal of ensemble world models."""
        preds = self.member_predict(xc, u, t, stacked_params)
        return jnp.std(preds[:, : self.x_size], axis=0)
