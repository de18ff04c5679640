"""Structural typing contracts for the model zoo.

Capability parity with the reference's abstract bases
(``/root/reference/base.py:4-49``), expressed the idiomatic-Python way as
``typing.Protocol`` (structural duck typing — any object with the right
methods conforms; no inheritance required, which keeps models as plain
dataclass modules / pytree wrappers). ``runtime_checkable`` lets factories
validate components at wiring time.
"""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import jax


@runtime_checkable
class CostModel(Protocol):
    """Planner stage/terminal cost. t == horizon selects the terminal."""

    horizon: int

    def init(self, key: jax.Array, xc_size: int): ...

    def __call__(
        self,
        xc: jax.Array,
        u: jax.Array,
        t: jax.Array,
        net_params,
        raw_weights: jax.Array,
        goal_X: jax.Array,
    ) -> jax.Array: ...


@runtime_checkable
class DynamicsModel(Protocol):
    """Planner dynamics f(xc, u, t) with a (possibly width-0) recurrent
    carry packed into the flat planner state xc."""

    x_size: int
    carry_size: int

    def init(self, key: jax.Array, u_size: int): ...

    def zero_carry(self) -> jax.Array: ...

    def warm_carry(
        self, params, history_x: jax.Array, history_u: jax.Array
    ) -> jax.Array: ...

    def __call__(
        self, xc: jax.Array, u: jax.Array, t: jax.Array, params
    ) -> jax.Array: ...


@runtime_checkable
class CriticModel(Protocol):
    """Sequence discriminator: (seq_len, x) -> scalar realness score."""

    def init_params(self, key: jax.Array, x_size: int): ...

    def apply(self, params, xseq: jax.Array) -> jax.Array: ...


@runtime_checkable
class ExpertModel(Protocol):
    """Autoregressive expert predictor supplying plan-time goals."""

    x_size: int
    u_size: int

    def init_params(self, key: jax.Array): ...

    def warm_carry(self, params, history_x: jax.Array): ...

    def generate(
        self, params, carry, horizon: int
    ) -> Tuple[jax.Array, jax.Array]: ...
