"""Cart-pole balance (pure JAX), dm-exact to dm_control's cartpole.

Present in the reference configs
(``/root/reference/config/l2_hyperparameters.yaml:7``). The dynamics
reproduce the MuJoCo ``cartpole.xml`` model (verified against dm_control
in tests/test_dm_parity.py): cart mass 1 sliding on x, pole mass 0.1
with COM at r = 0.5 from the hinge and 0.00942459 inertia about its COM,
slide gear 10, joint dampings (5e-4, 2e-6) applied EXPLICITLY inside
each RK4 stage (implicit damping is an Euler-integrator feature; see
the pendulum env), dt = 0.01, 1000-step episodes (the suite's
10-second limit). Observation [cart_x, cos th, sin th, cart_xd, th_d];
th = 0 is upright. Task protocol matches ``cartpole.Balance``: dense
shaped reward (upright x centered x small-control x small-velocity) and
the suite's initialization distribution.

Mass matrix of the 2-DoF system (x, th):
    M = [[mc + mp,        mp r cos th ],
         [mp r cos th,    mp r^2 + Ic ]]
bias  = [-mp r sin th * thd^2, -mp g r sin th]   (Coriolis + gravity)
``cartpole.xml`` sets integrator="RK4" (unlike pendulum's Euler), so the
step is classic 4th-order Runge-Kutta on (q, v) with explicit damping,
control held constant — exactly MuJoCo's mj_RungeKutta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gan_mpc_tpu.envs import base
from gan_mpc_tpu.utils import struct


class CartpoleParams(struct.PyTreeNode):
    body_mass_cart: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))
    body_mass_pole_1: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.1))
    geom_size_pole_1: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.5))  # COM distance r
    pole_com_inertia: jax.Array = struct.field(default_factory=lambda: jnp.float32(0.00942459))
    gravity: jax.Array = struct.field(default_factory=lambda: jnp.float32(9.81))
    force_gain: jax.Array = struct.field(default_factory=lambda: jnp.float32(10.0))
    damping_slider: jax.Array = struct.field(default_factory=lambda: jnp.float32(5.0e-4))
    damping_hinge: jax.Array = struct.field(default_factory=lambda: jnp.float32(2.0e-6))


class CartpoleBalance:
    obs_size = 5
    act_size = 1
    dt = 0.01
    episode_steps = 1000
    name = "cartpole_balance"

    def default_params(self) -> CartpoleParams:
        return CartpoleParams()

    def reset(self, params: CartpoleParams, key: jax.Array) -> base.EnvState:
        # suite cartpole.Balance.initialize_episode (non-swing-up branch):
        # slider uniform(-0.1, 0.1), hinge uniform(-0.034, 0.034),
        # velocities 0.01 * randn.
        k1, k2, k3 = jax.random.split(key, 3)
        x = jax.random.uniform(k1, (), minval=-0.1, maxval=0.1)
        th = jax.random.uniform(k2, (), minval=-0.034, maxval=0.034)
        qvel = 0.01 * jax.random.normal(k3, (2,))
        return base.EnvState(
            qpos=jnp.array([x, th], dtype=jnp.float32),
            qvel=qvel.astype(jnp.float32),
            t=jnp.int32(0),
        )

    def step(self, params: CartpoleParams, state: base.EnvState, action):
        u = jnp.clip(action, -1.0, 1.0)[0]
        mc, mp = params.body_mass_cart, params.body_mass_pole_1
        r = params.geom_size_pole_1
        g = params.gravity
        dtype = state.qpos.dtype
        h = jnp.asarray(self.dt, dtype)
        tau = jnp.array([params.force_gain * u, 0.0], dtype)
        damping = jnp.array(
            [params.damping_slider, params.damping_hinge], dtype
        )

        def qacc(q, v):
            th, thd = q[1], v[1]
            sin, cos = jnp.sin(th), jnp.cos(th)
            M = jnp.array(
                [
                    [mc + mp, mp * r * cos],
                    [mp * r * cos, mp * r**2 + params.pole_com_inertia],
                ],
                dtype,
            )
            bias = jnp.array(
                [-mp * r * sin * thd**2, -mp * g * r * sin], dtype
            )
            return jnp.linalg.solve(M, tau - bias - damping * v)

        def deriv(qv):
            q, v = qv
            return (v, qacc(q, v))

        # classic RK4 on (q, v), matching mj_RungeKutta
        y0 = (state.qpos, state.qvel)
        k1 = deriv(y0)
        add = lambda y, k, c: jax.tree.map(lambda a, b: a + c * b, y, k)
        k2 = deriv(add(y0, k1, h / 2.0))
        k3 = deriv(add(y0, k2, h / 2.0))
        k4 = deriv(add(y0, k3, h))
        qpos, qvel = jax.tree.map(
            lambda a, b1, b2, b3, b4: a
            + (h / 6.0) * (b1 + 2.0 * b2 + 2.0 * b3 + b4),
            y0,
            k1,
            k2,
            k3,
            k4,
        )
        new_state = base.EnvState(qpos=qpos, qvel=qvel, t=state.t + 1)

        upright = (jnp.cos(qpos[1]) + 1.0) / 2.0
        centered = (1.0 + base.tolerance(qpos[0], margin=2.0)) / 2.0
        small_control = (
            4.0
            + base.tolerance(
                u, margin=1.0, value_at_margin=0.0, sigmoid="quadratic"
            )
        ) / 5.0
        small_velocity = (1.0 + base.tolerance(qvel[1], margin=5.0)) / 2.0
        reward = upright * centered * small_control * small_velocity
        return new_state, reward

    def observe(self, params: CartpoleParams, state: base.EnvState):
        x, th = state.qpos
        return jnp.array([x, jnp.cos(th), jnp.sin(th), state.qvel[0], state.qvel[1]])
