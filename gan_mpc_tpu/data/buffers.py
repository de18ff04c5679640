"""Device-resident replay buffer.

Capability parity with ``/root/reference/data_buffers.py:33-77``
(``ReplayBuffer``: a deque of horizon-length sliding windows harvested from
on-policy trajectories), redesigned as fixed-shape HBM-resident arrays with
a ring write pointer, so adding a freshly collected (batched) trajectory
and sampling minibatches both happen inside jit — no host round trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gan_mpc_tpu.data.windows import sequence_windows
from gan_mpc_tpu.utils import struct


class ReplayBuffer(struct.PyTreeNode):
    states: jax.Array  # (capacity, seqlen, x)
    actions: jax.Array  # (capacity, seqlen, u)
    next_states: jax.Array  # (capacity, seqlen, x)
    ptr: jax.Array  # int32 next write slot
    size: jax.Array  # int32 valid entries

    @property
    def capacity(self) -> int:
        return self.states.shape[0]

    @classmethod
    def create(
        cls, capacity: int, seqlen: int, x_size: int, u_size: int
    ) -> "ReplayBuffer":
        return cls(
            states=jnp.zeros((capacity, seqlen, x_size), jnp.float32),
            actions=jnp.zeros((capacity, seqlen, u_size), jnp.float32),
            next_states=jnp.zeros((capacity, seqlen, x_size), jnp.float32),
            ptr=jnp.int32(0),
            size=jnp.int32(0),
        )

    def add_windows(
        self, xw: jax.Array, uw: jax.Array, yw: jax.Array
    ) -> "ReplayBuffer":
        """Insert pre-windowed sequences (n, seqlen, ·) at the ring head."""
        n = xw.shape[0]
        idx = (self.ptr + jnp.arange(n)) % self.capacity
        return self.replace(
            states=self.states.at[idx].set(xw),
            actions=self.actions.at[idx].set(uw),
            next_states=self.next_states.at[idx].set(yw),
            ptr=(self.ptr + n) % self.capacity,
            size=jnp.minimum(self.size + n, self.capacity),
        )

    def add_trajectories(
        self, states: jax.Array, actions: jax.Array
    ) -> "ReplayBuffer":
        """Window (B, T, ·) raw trajectories and insert them
        (the reference's ``ReplayBuffer.add``, ``data_buffers.py:62-70``;
        normalization is the caller's job, as there it was the buffer's)."""
        seqlen = self.states.shape[1]
        xw, uw, yw = sequence_windows(states, actions, seqlen)
        return self.add_windows(xw, uw, yw)

    def sample(self, key: jax.Array, steps: int, batch_size: int):
        """(steps, batch) minibatches of (x, u, next_x) windows."""
        idx = jax.random.randint(
            key, (steps, batch_size), 0, jnp.maximum(self.size, 1)
        )
        return self.states[idx], self.actions[idx], self.next_states[idx]
