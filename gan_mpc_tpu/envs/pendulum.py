"""Torque-limited pendulum swingup (pure JAX), bit-exact to dm_control.

The reference's default env is dm_control's ``pendulum_swingup``
(``/root/reference/config/gan_hyperparameters.yaml:8``). This step
reproduces the MuJoCo model exactly (verified to machine precision over
200 random-action steps against dm_control in tests/test_dm_parity.py):
a point mass m = 1 at r = 0.5 from the hinge with 0.001 inertia about
its COM (``pendulum.xml``: body_ipos z = 0.5, body_inertia 0.001),
actuator gear 1, joint damping 0.1 integrated IMPLICITLY (MuJoCo's Euler
integrator), semi-implicit Euler at dt = 0.02.

Task details match the suite task: observation [cos th, sin th, th_dot],
reward 1 while the pole is within 8 degrees of vertical
(tolerance(cos th, (cos 8deg, 1))), 1000-step episodes, initial pole
angle uniform in [-pi, pi) with zero velocity. th = 0 is upright.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from gan_mpc_tpu.envs import base
from gan_mpc_tpu.utils import struct

# Pure-Python so importing this module never initializes a JAX backend
# (the driver's dryrun must be able to force a CPU backend first).
_COS_BOUND = math.cos(math.radians(8.0))


class PendulumParams(struct.PyTreeNode):
    body_mass_pole: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))
    geom_size_pole: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.5))  # COM distance r
    com_inertia: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.001))
    gravity: jax.Array = struct.field(default_factory=lambda: jnp.float32(9.81))
    damping: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.1))
    torque_gain: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))


class PendulumSwingup:
    obs_size = 3
    act_size = 1
    dt = 0.02
    episode_steps = 1000
    name = "pendulum_swingup"

    def default_params(self) -> PendulumParams:
        return PendulumParams()

    def reset(self, params: PendulumParams, key: jax.Array) -> base.EnvState:
        # suite task: pole angle uniform in [-pi, pi), zero velocity
        # (dm_control pendulum.SwingUp.initialize_episode).
        th = jax.random.uniform(key, (), minval=-jnp.pi, maxval=jnp.pi)
        return base.EnvState(
            qpos=jnp.array([th], dtype=jnp.float32),
            qvel=jnp.zeros(1, dtype=jnp.float32),
            t=jnp.int32(0),
        )

    def inertia(self, params: PendulumParams):
        """Moment of inertia about the hinge (parallel-axis)."""
        return (
            params.body_mass_pole * params.geom_size_pole**2
            + params.com_inertia
        )

    def step(self, params: PendulumParams, state: base.EnvState, action):
        u = jnp.clip(action, -1.0, 1.0)[0]
        th, thd = state.qpos[0], state.qvel[0]
        m, r = params.body_mass_pole, params.geom_size_pole
        inertia = self.inertia(params)
        torque = params.torque_gain * u + m * params.gravity * r * jnp.sin(th)
        # MuJoCo's Euler integrator applies joint damping implicitly:
        # (I + dt*b) thd_next = I thd + dt*tau.
        thd = (thd + self.dt * torque / inertia) / (
            1.0 + self.dt * params.damping / inertia
        )
        th = th + self.dt * thd
        new_state = base.EnvState(
            qpos=jnp.array([th]), qvel=jnp.array([thd]), t=state.t + 1
        )
        reward = base.tolerance(jnp.cos(th), lower=_COS_BOUND, upper=1.0)
        return new_state, reward

    def observe(self, params: PendulumParams, state: base.EnvState):
        th = state.qpos[0]
        return jnp.array([jnp.cos(th), jnp.sin(th), state.qvel[0]])
