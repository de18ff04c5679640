"""Cheetah-run: planar locomotion on the differentiable multilink engine.

Task-equivalent to dm_control's ``cheetah_run`` (present in the reference
configs, ``/root/reference/config/gan_hyperparameters.yaml:26-33``):
observation = 8 positions (root z, pitch, 6 leg joints — root x excluded)
+ 9 velocities = 17 dims; 6 bounded torque actuators; reward is the
linear speed ramp ``clip(forward_speed / 10, 0, 1)``; 1000-step episodes.

Exposes the reference's imitator domain-shift knobs as named physics
fields: ``body_mass_torso``, ``jnt_stiffness_bfoot``,
``jnt_stiffness_ffoot`` (``/root/reference/config/gan_hyperparameters.yaml:28-33``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.envs import base
from gan_mpc_tpu.envs.planar import PlanarModel, step as planar_step
from gan_mpc_tpu.utils import struct

# Link order: torso(root), bthigh, bshin, bfoot, fthigh, fshin, ffoot.
_PARENT = (-1, 0, 1, 2, 0, 4, 5)
_LENGTHS = np.array([1.0, 0.29, 0.30, 0.19, 0.27, 0.21, 0.14])
_MASSES = np.array([6.4, 1.5, 1.6, 1.1, 1.4, 1.2, 0.9])
_ANCHORS = np.array(
    [
        [0.0, 0.0],     # root (unused)
        [-0.5, 0.0],    # bthigh at torso rear
        [0.0, -0.29],   # bshin at bthigh distal end
        [0.0, -0.30],   # bfoot at bshin distal end
        [0.5, 0.0],     # fthigh at torso front
        [0.0, -0.27],   # fshin
        [0.0, -0.21],   # ffoot
    ]
)
# COM midway along each limb (torso COM at root origin).
_COM = np.array(
    [[0.0, 0.0]]
    + [[0.0, -float(l) / 2.0] for l in _LENGTHS[1:]]
)
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
_STIFFNESS = np.array([0.0, 240.0, 180.0, 120.0, 180.0, 120.0, 60.0])
_DAMPING = np.array([0.0, 6.0, 4.5, 3.0, 4.5, 3.0, 1.5])
# Rest pose: back leg bent so both feet reach the same ground height
# (back chain 0.78 long vs front 0.62; see tests for the settle check).
_REF = np.array([0.0, 0.9, -0.75, 0.35, 0.0, 0.0, 0.0])
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-0.52, 1.05],
        [-0.79, 0.79],
        [-0.40, 0.79],
        [-1.00, 0.70],
        [-1.20, 0.87],
        [-0.50, 0.50],
    ]
)
_GEAR = np.array([0.0, 120.0, 90.0, 60.0, 120.0, 60.0, 30.0])
# Contacts: both feet tips, torso rear-bottom and the "head".
_CONTACT_BODY = (3, 6, 0, 0)
_CONTACT_OFFSET = np.array(
    [[0.0, -0.19], [0.0, -0.14], [-0.5, -0.05], [0.6, 0.05]]
)


class CheetahParams(struct.PyTreeNode):
    body_mass_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(6.4))
    jnt_stiffness_bfoot: jax.Array = struct.field(default_factory=lambda: jnp.float32(120.0))
    jnt_stiffness_ffoot: jax.Array = struct.field(default_factory=lambda: jnp.float32(60.0))
    geom_size_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))


class CheetahRun:
    obs_size = 17
    act_size = 6
    dt = 0.01
    episode_steps = 1000
    name = "cheetah_run"
    _substeps = 4

    def default_params(self) -> CheetahParams:
        return CheetahParams()

    def _model(self, params: CheetahParams) -> PlanarModel:
        masses = jnp.asarray(_MASSES).at[0].set(params.body_mass_torso)
        stiff = (
            jnp.asarray(_STIFFNESS).at[3]
            .set(params.jnt_stiffness_bfoot)
            .at[6]
            .set(params.jnt_stiffness_ffoot)
        )
        scale = params.geom_size_torso
        anchors = jnp.asarray(_ANCHORS).at[1, 0].set(-0.5 * scale).at[4, 0].set(0.5 * scale)
        inertia = jnp.asarray(_INERTIA).at[0].set(
            params.body_mass_torso * (scale * _LENGTHS[0]) ** 2 / 12.0
        )
        return PlanarModel(
            parent=_PARENT,
            joint_anchor=anchors,
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

    def reset(self, params: CheetahParams, key: jax.Array) -> base.EnvState:
        k1, k2 = jax.random.split(key)
        # qpos = (x, z, pitch, 6 hinge angles at their rest pose)
        qpos = jnp.concatenate([jnp.array([0.0, 0.64, 0.0]), _REF[1:]])
        qpos = qpos + 0.01 * jax.random.normal(k1, (9,))
        qvel = 0.01 * jax.random.normal(k2, (9,))
        return base.EnvState(
            qpos=qpos.astype(jnp.float32),
            qvel=qvel.astype(jnp.float32),
            t=jnp.int32(0),
        )

    def step(self, params: CheetahParams, state: base.EnvState, action):
        u = jnp.clip(action, -1.0, 1.0)
        model = self._model(params)
        q, qd = planar_step(
            model, state.qpos, state.qvel, u, self.dt, self._substeps
        )
        new_state = base.EnvState(qpos=q, qvel=qd, t=state.t + 1)
        speed = qd[0]
        reward = base.tolerance(
            speed,
            lower=10.0,
            upper=jnp.inf,
            margin=10.0,
            sigmoid="linear",
            value_at_margin=0.0,
        )
        return new_state, reward

    def observe(self, params: CheetahParams, state: base.EnvState):
        return jnp.concatenate([state.qpos[1:], state.qvel])
