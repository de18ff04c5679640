"""Plain-JAX layers that keep flax.linen's parameter layout.

Parameters are nested dicts named the way flax names auto-created
submodules (``Dense_0``, ``Dense_1``, ``OptimizedLSTMCell_0`` ...) with
flax's leaf names and initializers, so params files written by the flax
versions of the models load unchanged and ``ops.fused_mlp.dense_stack``
reads the same trees.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from gan_mpc_tpu.ops.fused_mlp import mlp_apply

_kernel_init = jax.nn.initializers.lecun_normal()
_recurrent_init = jax.nn.initializers.orthogonal()
_GATES = ("i", "f", "g", "o")


def dense_init(key: jax.Array, fin: int, fout: int) -> dict:
    return {
        "kernel": _kernel_init(key, (fin, fout), jnp.float32),
        "bias": jnp.zeros((fout,), jnp.float32),
    }


def mlp_init(
    key: jax.Array, fin: int, widths: Sequence[int], first: int = 0
) -> dict:
    """``Dense_{first}``... for the layer widths ``fin -> widths[0] -> ...``."""
    keys = jax.random.split(key, len(widths))
    sizes = [fin, *widths]
    return {
        f"Dense_{first + i}": dense_init(k, sizes[i], sizes[i + 1])
        for i, k in enumerate(keys)
    }


def mlp(p: dict, x: jax.Array, n_layers: int, first: int = 0) -> jax.Array:
    """relu after every layer but the last of ``Dense_{first}``..."""
    layers = [p[f"Dense_{first + i}"] for i in range(n_layers)]
    return mlp_apply(x, [(d["kernel"], d["bias"]) for d in layers])


def lstm_init(key: jax.Array, fin: int, features: int) -> dict:
    """flax ``OptimizedLSTMCell`` params: input kernels ``i{gate}`` and
    recurrent kernels with bias ``h{gate}`` for gates i, f, g, o."""
    keys = jax.random.split(key, 2 * len(_GATES))
    p = {}
    for j, g in enumerate(_GATES):
        p[f"i{g}"] = {"kernel": _kernel_init(keys[2 * j], (fin, features))}
        p[f"h{g}"] = {
            "kernel": _recurrent_init(keys[2 * j + 1], (features, features)),
            "bias": jnp.zeros((features,), jnp.float32),
        }
    return p


def lstm(p: dict, carry, x: jax.Array):
    """One LSTM step: ``(c, h), x -> ((c', h'), h')`` (flax's gate math)."""
    c, h = carry
    def stacked(prefix, leaf):
        return jnp.concatenate([p[prefix + g][leaf] for g in _GATES], -1)

    zh = jnp.dot(h, stacked("h", "kernel")) + stacked("h", "bias")
    zi = jnp.dot(x, stacked("i", "kernel"))
    hi, hf, hg, ho = jnp.split(zh, 4, axis=-1)
    ii, if_, ig, io = jnp.split(zi, 4, axis=-1)
    i = jax.nn.sigmoid(hi + ii)
    f = jax.nn.sigmoid(hf + if_)
    g = jnp.tanh(hg + ig)
    o = jax.nn.sigmoid(ho + io)
    new_c = f * c + i * g
    new_h = o * jnp.tanh(new_c)
    return (new_c, new_h), new_h
