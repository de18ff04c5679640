"""Expert prediction model: an autoregressive state-action sequence model.

Capability parity with ``/root/reference/expert/nn.py`` +
``/root/reference/expert/expert_model.py``:

  * per-step cell emits (next_x, u): ``next_x`` is residual on the input
    state, ``u`` is tanh-squashed;
  * the teacher-forcing switch lives INSIDE the cell (``jnp.where(tf, x,
    x_prev)``) so open/closed-loop unrolls are the same compiled program;
  * MLP and LSTM cell variants, named in the param tree as the flax
    submodules they were. Cell-inventory mapping to the reference:
    ``_MLPCell`` = ``StackedMLPCell`` (``expert/nn.py:22-40`` — shared
    relu trunk + two deep heads; that IS the reference's "mlp" arch,
    scanned by ``ScanMLP``), ``_PredictionHeads`` = its plain ``MLPCell``
    head submodule (``expert/nn.py:10-19``), ``_LSTMCell`` = ``LSTMCell``
    (``expert/nn.py:43-61``) — all three reference cells are covered;
  * plan-time services: warm a carry from the observed state history, then
    autoregressively generate the goal state sequence and warm-start action
    sequence for the MPC planner (``expert_model.py:60-91``).

Modules here operate on a single unbatched sequence (seq_len, x_size);
batching is ``jax.vmap`` at the call site — idiomatic JAX, and it shards
cleanly under ``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.layers import lstm, lstm_init, mlp, mlp_init


def _heads_init(key, fin, x_size, u_size, hidden) -> dict:
    """Two relu heads on the trunk feature: ``Dense_0..L`` for next_x,
    ``Dense_{L+1}..2L+1`` for u (flax's creation order)."""
    kx, ku = jax.random.split(key)
    p = mlp_init(kx, fin, (*hidden, x_size))
    p.update(mlp_init(ku, fin, (*hidden, u_size), first=len(hidden) + 1))
    return p


def _heads(p, y, x, n_hidden):
    """Maps a trunk feature y (and input state x) to (next_x, u)."""
    next_x = mlp(p, y, n_hidden + 1) + x
    u = jnp.tanh(mlp(p, y, n_hidden + 1, first=n_hidden + 1))
    return next_x, u


@dataclasses.dataclass(frozen=True)
class ExpertPredictor:
    """Scans the prediction cell over a state sequence.

    ``apply(params, carry, xseq, teacher_forcing)`` with xseq
    (seq_len, x_size) returns ``(carry, (next_xseq, useq))``.
    ``teacher_forcing`` may be a traced boolean — open vs. closed loop
    does not recompile. The cell is the reference's ``LSTMCell`` (arch
    "lstm") or ``StackedMLPCell`` (arch "mlp": a relu trunk layer, then
    the two heads).
    """

    x_size: int
    u_size: int
    arch: str = "lstm"  # "mlp" | "lstm"
    features: int = 128
    hidden: Sequence[int] = (128, 128)

    def init_carry(self, x0: jax.Array):
        """Recurrent state for a fresh sequence starting at x0."""
        if self.arch == "lstm":
            zeros = jnp.zeros((self.features,), dtype=jnp.float32)
            return ((zeros, zeros), x0)
        return (x0,)

    def _check_arch(self):
        if self.arch not in ("lstm", "mlp"):
            raise ValueError(f"unknown expert arch {self.arch!r}")

    def init(self, key: jax.Array, carry, xseq: jax.Array, teacher_forcing):
        self._check_arch()
        k_trunk, k_heads = jax.random.split(key)
        if self.arch == "lstm":
            cell = {
                "OptimizedLSTMCell_0": lstm_init(
                    k_trunk, self.x_size, self.features
                ),
                "_PredictionHeads_0": _heads_init(
                    k_heads, self.features, self.x_size, self.u_size,
                    self.hidden,
                ),
            }
            return {"params": {"_LSTMCell_0": cell}}
        cell = mlp_init(k_trunk, self.x_size, (self.hidden[0],))
        cell["_PredictionHeads_0"] = _heads_init(
            k_heads, self.hidden[0], self.x_size, self.u_size, self.hidden
        )
        return {"params": {"_MLPCell_0": cell}}

    def apply(self, params, carry, xseq: jax.Array, teacher_forcing):
        self._check_arch()
        n_hidden = len(self.hidden)
        if self.arch == "lstm":
            p = params["params"]["_LSTMCell_0"]

            def cell(carry, x_t):
                lstm_state, x_prev = carry
                x = jnp.where(teacher_forcing, x_t, x_prev)
                lstm_state, y = lstm(p["OptimizedLSTMCell_0"], lstm_state, x)
                next_x, u = _heads(p["_PredictionHeads_0"], y, x, n_hidden)
                return (lstm_state, next_x), (next_x, u)

        else:
            p = params["params"]["_MLPCell_0"]

            def cell(carry, x_t):
                (x_prev,) = carry
                x = jnp.where(teacher_forcing, x_t, x_prev)
                y = jax.nn.relu(mlp(p, x, 1))
                next_x, u = _heads(p["_PredictionHeads_0"], y, x, n_hidden)
                return (next_x,), (next_x, u)

        return jax.lax.scan(cell, carry, xseq)

    # -- plan-time / train-time services --------------------------------

    def init_params(self, key: jax.Array):
        x0 = jnp.zeros((self.x_size,))
        return self.init(key, self.init_carry(x0), x0[None], True)

    def warm_carry(self, params, history_x: jax.Array):
        """Teacher-forced replay of the history -> carry poised at the
        current state. history_x: (h + 1, x_size); the last row is the
        current state, which becomes the autoregressive seed."""
        carry = self.init_carry(history_x[0])
        carry, _ = self.apply(params, carry, history_x[:-1], True)
        if self.arch == "lstm":
            lstm_state, _ = carry
            return (lstm_state, history_x[-1])
        return (history_x[-1],)

    def generate(self, params, carry, horizon: int):
        """Autoregressive rollout of the expert's predicted future.

        Returns ``(goal_xseq, useq)`` with shapes (horizon + 1, x_size) and
        (horizon, u_size); ``goal_xseq[0]`` is the current state held in
        the carry (matches the reference's goal/warm-start contract,
        ``/root/reference/policy/eval.py:88-107``).
        """
        x_now = carry[-1]
        placeholder = jnp.zeros((horizon, self.x_size), dtype=jnp.float32)
        _, (next_xseq, useq) = self.apply(params, carry, placeholder, False)
        goal_xseq = jnp.concatenate([x_now[None], next_xseq], axis=0)
        return goal_xseq, useq
