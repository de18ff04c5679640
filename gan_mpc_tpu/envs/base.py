"""Pure-JAX environment substrate.

The reference steps dm_control/MuJoCo (C code, host) once per control step
(``/root/reference/utils.py:254-290``) — a device<->host round trip per
step, the central inefficiency SURVEY.md §3.4 identifies. Here the
environment IS a jittable function: ``reset``/``step``/``observe`` are pure,
physics parameters are a pytree (so "domain shift" is a pytree transform),
and whole episodes run inside one ``lax.scan``, batched with ``vmap`` and
sharded with ``shard_map``.

Env API:
    env.obs_size / env.act_size / env.dt / env.episode_steps
    env.default_params() -> params pytree (utils.struct dataclass)
    env.reset(params, key) -> EnvState
    env.step(params, state, action) -> (EnvState, reward)
    env.observe(params, state) -> (obs_size,) observation
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp

from gan_mpc_tpu.utils import struct


class EnvState(struct.PyTreeNode):
    qpos: jax.Array  # generalized positions
    qvel: jax.Array  # generalized velocities
    t: jax.Array  # step counter (int32)


# ---------------------------------------------------------------------------
# dm_control-style shaped rewards
# ---------------------------------------------------------------------------


def tolerance(
    x,
    lower: float = 0.0,
    upper: float = 0.0,
    margin: float = 0.0,
    sigmoid: str = "gaussian",
    value_at_margin: float = 0.1,
):
    """Reward 1 inside [lower, upper], decaying outside over `margin`.

    Mirrors the semantics of dm_control's ``rewards.tolerance`` (used for
    every task reward in the suite) so task rewards here match the
    reference's reward surfaces.
    """
    in_bounds = jnp.logical_and(lower <= x, x <= upper)
    if margin == 0.0:
        return jnp.where(in_bounds, 1.0, 0.0)
    d = jnp.where(x < lower, lower - x, x - upper) / margin
    # double-where: zero the unused branch BEFORE the sigmoid, else with
    # upper=inf the untaken d=-inf produces 0*inf=NaN in the BACKWARD pass
    # (reward gradients through the engine — APG/BPTT — would NaN out)
    d = jnp.where(in_bounds, 0.0, d)
    if sigmoid == "gaussian":
        scale = jnp.sqrt(-2.0 * jnp.log(value_at_margin))
        out = jnp.exp(-0.5 * (d * scale) ** 2)
    elif sigmoid == "linear":
        scale = 1.0 - value_at_margin
        out = jnp.clip(1.0 - d * scale, 0.0, 1.0)
    elif sigmoid == "quadratic":
        scale = jnp.sqrt(1.0 - value_at_margin)
        out = jnp.clip(1.0 - (d * scale) ** 2, 0.0, 1.0)
    else:
        raise ValueError(f"unknown sigmoid {sigmoid!r}")
    return jnp.where(in_bounds, 1.0, out)


# ---------------------------------------------------------------------------
# Domain shift (imitator physics perturbation)
# ---------------------------------------------------------------------------

_SHIFT_PATTERNS = ("body_mass_", "geom_size_", "jnt_stiffness_")


def apply_physics_shift(params, shifts):
    """Multiply named physics fields, reproducing the reference's imitator
    domain-shift mechanism (``/root/reference/utils.py:43-62``).

    ``shifts`` is a list of ``{"key": "body_mass_pole", "value": 2.0}``
    entries (same schema as the reference YAML). Keys name fields of the
    env's params dataclass directly; unknown keys raise.
    """
    field_names = {f.name for f in dataclasses.fields(params)}
    updates = {}
    for kv in shifts:
        key, value = kv["key"], float(kv["value"])
        if not re.match("|".join(_SHIFT_PATTERNS), key):
            raise ValueError(f"unsupported physics-shift key {key!r}")
        if key not in field_names:
            raise ValueError(
                f"{type(params).__name__} has no physics field {key!r}; "
                f"available: {sorted(n for n in field_names)}"
            )
        updates[key] = getattr(params, key) * value
    return params.replace(**updates)


def semi_implicit_euler(q, v, acc, dt):
    """MuJoCo-style semi-implicit Euler integration step."""
    v_next = v + dt * acc
    return q + dt * v_next, v_next
