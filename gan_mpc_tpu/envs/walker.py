"""Planar biped walker (walker2d-class) on the differentiable engine.

Scales the env family toward the humanoid-scale config (BASELINE.json
configs[4]): a 7-link biped — torso + two (thigh, shin, foot) legs — with
9 DoF, 6 bounded torque actuators, a dm_control-``walker_walk``-style
shaped reward (stand-tall x move-forward), and the same named
physics-shift fields pattern as the other envs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.envs import base
from gan_mpc_tpu.envs.planar import PlanarModel, step as planar_step
from gan_mpc_tpu.utils import struct

# Bodies: torso(root, extends UP from hip), lthigh, lshin, lfoot,
#         rthigh, rshin, rfoot.
_PARENT = (-1, 0, 1, 2, 0, 4, 5)
_MASSES = np.array([3.5, 0.9, 0.6, 0.3, 0.9, 0.6, 0.3])
_ANCHORS = np.array(
    [
        [0.0, 0.0],
        [0.0, 0.0],     # left thigh at the hip (root origin)
        [0.0, -0.45],   # left shin at thigh end
        [0.0, -0.5],    # left foot at shin end
        [0.0, 0.0],     # right thigh at the hip
        [0.0, -0.45],
        [0.0, -0.5],
    ]
)
_LENGTHS = np.array([0.6, 0.45, 0.5, 0.2, 0.45, 0.5, 0.2])
# torso COM is ABOVE the hip (+z in body frame); limbs extend down.
_COM = np.array(
    [[0.0, 0.3]]
    + [[0.0, -float(l) / 2.0] for l in _LENGTHS[1:]]
)
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
_STIFFNESS = np.array([0.0, 30.0, 20.0, 40.0, 30.0, 20.0, 40.0])
_DAMPING = np.array([0.0, 2.0, 1.5, 1.0, 2.0, 1.5, 1.0])
_REF = np.zeros(7, np.float32)
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-1.0, 1.0],
        [-1.5, 0.0],
        [-0.8, 0.8],
        [-1.0, 1.0],
        [-1.5, 0.0],
        [-0.8, 0.8],
    ]
)
_GEAR = np.array([0.0, 60.0, 40.0, 20.0, 60.0, 40.0, 20.0])
# Heel and toe of each foot, plus hip and head so a fallen body rests on
# the ground instead of passing through it.
_CONTACT_BODY = (3, 3, 6, 6, 0, 0)
_CONTACT_OFFSET = np.array(
    [[-0.06, -0.2], [0.1, -0.2], [-0.06, -0.2], [0.1, -0.2],
     [0.0, 0.0], [0.0, 0.6]]
)


class WalkerParams(struct.PyTreeNode):
    body_mass_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(3.5))
    jnt_stiffness_left_hip: jax.Array = struct.field(default_factory=lambda: jnp.float32(30.0))
    jnt_stiffness_right_hip: jax.Array = struct.field(default_factory=lambda: jnp.float32(30.0))
    geom_size_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))


class WalkerWalk:
    obs_size = 17
    act_size = 6
    dt = 0.01
    episode_steps = 1000
    name = "walker_walk"
    _substeps = 4
    _stand_height = 1.0

    def default_params(self) -> WalkerParams:
        return WalkerParams()

    def _model(self, params: WalkerParams) -> PlanarModel:
        masses = jnp.asarray(_MASSES).at[0].set(params.body_mass_torso)
        stiff = (
            jnp.asarray(_STIFFNESS).at[1]
            .set(params.jnt_stiffness_left_hip)
            .at[4]
            .set(params.jnt_stiffness_right_hip)
        )
        inertia = jnp.asarray(_INERTIA).at[0].set(
            params.body_mass_torso
            * (params.geom_size_torso * _LENGTHS[0]) ** 2
            / 12.0
        )
        return PlanarModel(
            parent=_PARENT,
            joint_anchor=_ANCHORS,
            com_offset=_COM,
            mass=masses,
            inertia=inertia,
            joint_stiffness=stiff,
            joint_damping=_DAMPING,
            joint_ref=_REF,
            joint_range=_RANGE,
            gear=_GEAR,
            contact_body=_CONTACT_BODY,
            contact_offset=_CONTACT_OFFSET,
        )

    def reset(self, params: WalkerParams, key: jax.Array) -> base.EnvState:
        k1, k2 = jax.random.split(key)
        # hip at leg length (0.45 + 0.5 + 0.2), slight crouch
        qpos = jnp.zeros(9).at[1].set(1.13)
        qpos = qpos + 0.005 * jax.random.normal(k1, (9,))
        qvel = 0.005 * jax.random.normal(k2, (9,))
        return base.EnvState(
            qpos=qpos.astype(jnp.float32),
            qvel=qvel.astype(jnp.float32),
            t=jnp.int32(0),
        )

    def step(self, params: WalkerParams, state: base.EnvState, action):
        u = jnp.clip(action, -1.0, 1.0)
        model = self._model(params)
        q, qd = planar_step(
            model, state.qpos, state.qvel, u, self.dt, self._substeps
        )
        new_state = base.EnvState(qpos=q, qvel=qd, t=state.t + 1)
        torso_top = q[1] + 0.6 * jnp.cos(q[2])
        standing = base.tolerance(
            torso_top,
            lower=self._stand_height,
            upper=jnp.inf,
            margin=self._stand_height / 2.0,
        )
        upright = (1.0 + jnp.cos(q[2])) / 2.0
        stand_reward = (3.0 * standing + upright) / 4.0
        move = base.tolerance(
            qd[0],
            lower=1.0,
            upper=jnp.inf,
            margin=1.0,
            sigmoid="linear",
            value_at_margin=0.5,
        )
        reward = stand_reward * (5.0 * move + 1.0) / 6.0
        return new_state, reward

    def observe(self, params: WalkerParams, state: base.EnvState):
        return jnp.concatenate([state.qpos[1:], state.qvel])
