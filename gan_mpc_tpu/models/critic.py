"""Adversarial sequence critic (discriminator).

Capability parity with ``/root/reference/critic/nn.py``: an LSTM scans a
state sequence and an MLP head maps the final hidden output to a scalar
realness score. Operates on a single unbatched sequence; batch via vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.layers import lstm, lstm_init, mlp, mlp_init


@dataclasses.dataclass(frozen=True)
class SequenceCritic:
    """LSTM over (seq_len, x_size) -> scalar score."""

    features: int = 64
    hidden: Sequence[int] = (64,)

    def init(self, key: jax.Array, xseq: jax.Array) -> dict:
        k_cell, k_mlp = jax.random.split(key)
        p = {
            "ScanOptimizedLSTMCell_0": lstm_init(
                k_cell, xseq.shape[-1], self.features
            )
        }
        p.update(mlp_init(k_mlp, self.features, (*self.hidden, 1)))
        return {"params": p}

    def apply(self, params, xseq: jax.Array) -> jax.Array:
        p = params["params"]
        zeros = jnp.zeros((self.features,), dtype=xseq.dtype)
        _, outs = jax.lax.scan(
            lambda carry, x: lstm(p["ScanOptimizedLSTMCell_0"], carry, x),
            (zeros, zeros),
            xseq,
        )
        return mlp(p, outs[-1], len(self.hidden) + 1)[0]

    def init_params(self, key: jax.Array, x_size: int):
        return self.init(key, jnp.zeros((1, x_size)))
