"""Device-resident data normalization.

Capability parity with ``/root/reference/data_normalizer.py`` (standard /
identity / joint state+action), redesigned as a pytree of device arrays so
normalization happens inside jitted programs (the reference normalized in
host numpy on every buffer append, ``data_buffers.py:14-26``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gan_mpc_tpu.utils import struct


class Normalizer(struct.PyTreeNode):
    """(x - mean) / std per feature; identity when fitted with fit=False."""

    state_mean: jax.Array
    state_std: jax.Array
    action_mean: jax.Array
    action_std: jax.Array

    @classmethod
    def identity(cls, state_size: int, action_size: int) -> "Normalizer":
        return cls(
            state_mean=jnp.zeros((state_size,), jnp.float32),
            state_std=jnp.ones((state_size,), jnp.float32),
            action_mean=jnp.zeros((action_size,), jnp.float32),
            action_std=jnp.ones((action_size,), jnp.float32),
        )

    @classmethod
    def fit(
        cls,
        states: jax.Array,
        actions: jax.Array,
        normalize_state: bool = True,
        normalize_action: bool = False,
        eps: float = 1e-8,
    ) -> "Normalizer":
        """Fit on expert data (reference default: standard state norm,
        identity action norm; ``norm/runner.py:62-76``)."""
        s = states.reshape(-1, states.shape[-1]).astype(jnp.float32)
        a = actions.reshape(-1, actions.shape[-1]).astype(jnp.float32)
        ident = cls.identity(s.shape[-1], a.shape[-1])
        return cls(
            state_mean=jnp.mean(s, 0) if normalize_state else ident.state_mean,
            state_std=(
                jnp.std(s, 0) + eps if normalize_state else ident.state_std
            ),
            action_mean=(
                jnp.mean(a, 0) if normalize_action else ident.action_mean
            ),
            action_std=(
                jnp.std(a, 0) + eps if normalize_action else ident.action_std
            ),
        )

    def normalize_state(self, x):
        return (x - self.state_mean) / self.state_std

    def denormalize_state(self, x):
        return x * self.state_std + self.state_mean

    def normalize_action(self, u):
        return (u - self.action_mean) / self.action_std

    def denormalize_action(self, u):
        return u * self.action_std + self.action_mean
