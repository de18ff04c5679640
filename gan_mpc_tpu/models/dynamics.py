"""Learned dynamics models for the planner.

Capability parity with ``/root/reference/dynamics/nn.py`` +
``/root/reference/dynamics/dynamics_model.py``:

  * residual MLP: ``next_x = x + MLP([x, u])``;
  * LSTM variant that threads its recurrent state *inside the flat planner
    state vector* ``xc = [x, h, c]`` so the iLQR linearization
    differentiates through the recurrence (the reference's key trick,
    ``dynamics/nn.py:40-57`` — kept because the planner requires a flat
    differentiable state);
  * history warm-up: replay the recent (x, u) history through the cell to
    produce the carry used at plan time (``dynamics_model.py:24-43``), as a
    ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.layers import lstm, lstm_init, mlp, mlp_init


@dataclasses.dataclass(frozen=True)
class ResidualMLPDynamicsNet:
    """next_x = x + MLP([x, u]); carry-free (carry width 0)."""

    x_size: int
    hidden: Sequence[int] = (200, 200, 200)

    @property
    def carry_size(self) -> int:
        return 0

    def init(self, key: jax.Array, xc: jax.Array, u: jax.Array) -> dict:
        fin = self.x_size + u.shape[-1]
        return {"params": mlp_init(key, fin, (*self.hidden, self.x_size))}

    def apply(self, params, xc: jax.Array, u: jax.Array) -> jax.Array:
        x = xc[: self.x_size]
        h = jnp.concatenate([x, u], axis=-1)
        dx = mlp(params["params"], h, len(self.hidden) + 1)
        return jnp.concatenate([x + dx, xc[self.x_size :]], axis=-1)


@dataclasses.dataclass(frozen=True)
class LSTMDynamicsNet:
    """LSTM-backed residual dynamics with the carry packed into xc.

    xc layout: ``[x (x_size), h (features), c (features)]``.
    """

    x_size: int
    features: int = 64
    hidden: Sequence[int] = (128, 128)

    @property
    def carry_size(self) -> int:
        return 2 * self.features

    def init(self, key: jax.Array, xc: jax.Array, u: jax.Array) -> dict:
        k_cell, k_mlp = jax.random.split(key)
        p = {
            "OptimizedLSTMCell_0": lstm_init(
                k_cell, self.x_size + u.shape[-1], self.features
            )
        }
        p.update(
            mlp_init(k_mlp, self.features, (*self.hidden, self.x_size))
        )
        return {"params": p}

    def apply(self, params, xc: jax.Array, u: jax.Array) -> jax.Array:
        p = params["params"]
        x = xc[: self.x_size]
        h_state = xc[self.x_size : self.x_size + self.features]
        c_state = xc[self.x_size + self.features :]
        q = jnp.concatenate([x, u], axis=-1)
        (c_new, h_new), q = lstm(
            p["OptimizedLSTMCell_0"], (c_state, h_state), q
        )
        dx = mlp(p, q, len(self.hidden) + 1)
        return jnp.concatenate([x + dx, h_new, c_new], axis=-1)


class LearnedDynamics:
    """Planner-facing wrapper: f(xc, u, t) plus carry utilities."""

    def __init__(self, net):
        self.net = net
        self.x_size = net.x_size
        self.carry_size = net.carry_size

    def init(self, key: jax.Array, u_size: int):
        xc = jnp.zeros((self.x_size + self.carry_size,))
        return self.net.init(key, xc, jnp.zeros((u_size,)))

    def zero_carry(self) -> jax.Array:
        return jnp.zeros((self.carry_size,), dtype=jnp.float32)

    def __call__(
        self, xc: jax.Array, u: jax.Array, t: jax.Array, params
    ) -> jax.Array:
        del t
        return self.net.apply(params, xc, u)

    # -- batch-native planner hooks (carry-free MLP nets only) ----------

    @property
    def is_batch_native(self) -> bool:
        """True when the net supports the fused batch-major planner path
        (plain residual relu-MLP, no recurrent carry)."""
        return (
            isinstance(self.net, ResidualMLPDynamicsNet)
            and self.carry_size == 0
        )

    def batch_apply(
        self, params, X: jax.Array, U: jax.Array, compute_dtype=None
    ) -> jax.Array:
        """next_x for (N, n) states / (N, m) actions in one fused call.
        ``compute_dtype`` selects the GEMM dtype (bf16 path)."""
        from gan_mpc_tpu.ops.fused_mlp import dense_stack, mlp_apply

        z = jnp.concatenate([X, U], axis=-1)
        return X + mlp_apply(z, dense_stack(params), compute_dtype)

    def batch_value_and_jac(
        self, params, X: jax.Array, U: jax.Array, compute_dtype=None
    ):
        """(next_x (N,n), A (N,n,n), B (N,n,m)): fused forward + exact
        Jacobians of the residual MLP (relu nets are piecewise-linear, so
        the masked weight-product Jacobian is exact a.e.)."""
        from gan_mpc_tpu.ops.fused_mlp import dense_stack, mlp_value_and_jac

        n = X.shape[-1]
        z = jnp.concatenate([X, U], axis=-1)
        dx, J = mlp_value_and_jac(z, dense_stack(params), compute_dtype)
        A = J[..., :n] + jnp.eye(n, dtype=X.dtype)
        return X + dx, A, J[..., n:]

    def warm_carry(
        self, params, history_x: jax.Array, history_u: jax.Array
    ) -> jax.Array:
        """Replay (x, u) history through the cell to warm the carry.

        history_x: (h, x_size), history_u: (h, u_size). Starts from a zero
        carry, returns the carry after the last transition.
        """
        if self.carry_size == 0:
            # Carry-free nets: skip the replay scan entirely (a scan over
            # width-0 carries also trips an XLA CPU lowering bug when
            # fused with the solver's cholesky custom call).
            return self.zero_carry()

        def step(carry, xu):
            x, u = xu
            xc = jnp.concatenate([x, carry], axis=-1)
            next_xc = self.net.apply(params, xc, u)
            return next_xc[self.x_size :], None

        carry, _ = jax.lax.scan(step, self.zero_carry(), (history_x, history_u))
        return carry
