"""Planar humanoid (13 links, 15 DoF) on the differentiable engine.

The real humanoid-scale environment owed by BASELINE.json configs[4]
(round-1 shipped walker under the "humanoid_scale" name). A planar
kinematic tree: pelvis root + waist-hinged torso + neck-hinged head, two
(thigh, shin, foot) legs and two (upper-arm, forearm) arms — 12 actuated
hinges, 29-dim observation. Rewards follow dm_control's ``humanoid``
domain (stand / walk variants built from ``tolerance`` terms), matching
the reference's env source (``/root/reference/utils.py:38-40`` loads
arbitrary suite tasks; this provides the humanoid one natively).

Body index map (parent in brackets):
  0 pelvis(root)  1 torso[0]   2 head[1]
  3 lthigh[0]     4 lshin[3]   5 lfoot[4]
  6 rthigh[0]     7 rshin[6]   8 rfoot[7]
  9 luarm[1]     10 lfarm[9]  11 ruarm[1]  12 rfarm[11]
Hinge q indices: 3 waist, 4 neck, 5/8 hips, 6/9 knees, 7/10 ankles,
11/13 shoulders, 12/14 elbows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.envs import base
from gan_mpc_tpu.envs.planar import PlanarModel, step as planar_step
from gan_mpc_tpu.utils import struct

_PARENT = (-1, 0, 1, 0, 3, 4, 0, 6, 7, 1, 9, 1, 11)
_MASSES = np.array(
    [9.0, 12.0, 4.0, 4.5, 2.5, 1.0, 4.5, 2.5, 1.0, 1.5, 1.0, 1.5, 1.0]
)
_LENGTHS = np.array(
    [0.2, 0.45, 0.25, 0.4, 0.4, 0.15, 0.4, 0.4, 0.15, 0.3, 0.25, 0.3, 0.25]
)
_ANCHORS = np.array(
    [
        [0.0, 0.0],
        [0.0, 0.1],    # torso at pelvis top (waist)
        [0.0, 0.45],   # head at torso top (neck)
        [0.0, -0.1],   # left thigh at pelvis bottom (hip)
        [0.0, -0.4],   # left shin (knee)
        [0.0, -0.4],   # left foot (ankle)
        [0.0, -0.1],   # right thigh
        [0.0, -0.4],
        [0.0, -0.4],
        [0.0, 0.4],    # left upper arm at shoulder
        [0.0, -0.3],   # left forearm (elbow)
        [0.0, 0.4],    # right upper arm
        [0.0, -0.3],
    ]
)
# pelvis COM at root; torso/head extend up; limbs extend down.
_COM = np.array(
    [[0.0, 0.0], [0.0, 0.225], [0.0, 0.125]]
    + [[0.0, -float(l) / 2.0] for l in _LENGTHS[3:]]
)
_INERTIA = _MASSES * _LENGTHS**2 / 12.0
#        (root) waist neck  hip knee ankle  hip knee ankle  sho elb  sho elb
_STIFFNESS = np.array(
    [0.0, 60.0, 10.0, 20.0, 15.0, 60.0, 20.0, 15.0, 60.0, 10.0, 5.0, 10.0, 5.0]
)
_DAMPING = np.array(
    [0.0, 5.0, 1.0, 3.0, 2.0, 3.0, 3.0, 2.0, 3.0, 1.0, 0.5, 1.0, 0.5]
)
_REF = np.zeros(13, np.float32)
_RANGE = np.array(
    [
        [0.0, 0.0],
        [-0.8, 0.8],   # waist
        [-0.6, 0.6],   # neck
        [-1.2, 1.2],   # hips
        [-2.0, 0.0],   # knees
        [-0.9, 0.9],   # ankles
        [-1.2, 1.2],
        [-2.0, 0.0],
        [-0.9, 0.9],
        [-1.5, 1.5],   # shoulders
        [-2.0, 0.0],   # elbows
        [-1.5, 1.5],
        [-2.0, 0.0],
    ]
)
_GEAR = np.array(
    [0.0, 100.0, 10.0, 120.0, 80.0, 50.0, 120.0, 80.0, 50.0, 25.0, 15.0, 25.0, 15.0]
)
# Heel + toe of each foot; pelvis, head top, and both elbows so a fallen
# body rests on the ground instead of passing through it.
_CONTACT_BODY = (5, 5, 8, 8, 0, 2, 10, 12)
_CONTACT_OFFSET = np.array(
    [
        [-0.06, -0.15],
        [0.12, -0.15],
        [-0.06, -0.15],
        [0.12, -0.15],
        [0.0, -0.1],
        [0.0, 0.25],
        [0.0, -0.25],
        [0.0, -0.25],
    ]
)


class HumanoidParams(struct.PyTreeNode):
    body_mass_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(12.0))
    body_mass_pelvis: jax.Array = struct.field(default_factory=lambda: jnp.float32(9.0))
    jnt_stiffness_left_hip: jax.Array = struct.field(default_factory=lambda: jnp.float32(20.0))
    jnt_stiffness_right_hip: jax.Array = struct.field(default_factory=lambda: jnp.float32(20.0))
    geom_size_torso: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))


class _Humanoid:
    """Shared physics for the stand/walk task variants."""

    obs_size = 29
    act_size = 12
    dt = 0.01
    episode_steps = 1000
    _substeps = 4
    # standing head-top height: root z ~1.05 + pelvis 0.1 + torso 0.45
    # + head 0.25 = 1.85; reward asks for most of it.
    _stand_height = 1.6
    _move_speed = 0.0  # overridden by walk

    def default_params(self) -> HumanoidParams:
        return HumanoidParams()

    def _model(self, params: HumanoidParams) -> PlanarModel:
        masses = (
            jnp.asarray(_MASSES)
            .at[0]
            .set(params.body_mass_pelvis)
            .at[1]
            .set(params.body_mass_torso)
        )
        stiff = (
            jnp.asarray(_STIFFNESS)
            .at[3]
            .set(params.jnt_stiffness_left_hip)
            .at[6]
            .set(params.jnt_stiffness_right_hip)
        )
        inertia = jnp.asarray(_INERTIA).at[1].set(
            params.body_mass_torso
            * (params.geom_size_torso * _LENGTHS[1]) ** 2
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
            # stiffer ground than the lighter envs: the 46-kg body would
            # sink ~4 cm into the default 4 kN/m springs, which makes the
            # support compliant enough to destabilize standing.
            ground_kp=20000.0,
            ground_kd=500.0,
        )

    def reset(self, params: HumanoidParams, key: jax.Array) -> base.EnvState:
        k1, k2 = jax.random.split(key)
        # feet on the ground: ankle at 0.15, shins/thighs 0.8, pelvis half
        # 0.1 above the hip anchor -> root z ~= 1.05; tiny crouch noise.
        qpos = jnp.zeros(15).at[1].set(1.05)
        qpos = qpos + 0.005 * jax.random.normal(k1, (15,))
        qvel = 0.005 * jax.random.normal(k2, (15,))
        return base.EnvState(
            qpos=qpos.astype(jnp.float32),
            qvel=qvel.astype(jnp.float32),
            t=jnp.int32(0),
        )

    def _head_height(self, q: jax.Array) -> jax.Array:
        torso_ang = q[2] + q[3]
        head_ang = torso_ang + q[4]
        torso_base_z = q[1] + 0.1 * jnp.cos(q[2])
        head_base_z = torso_base_z + 0.45 * jnp.cos(torso_ang)
        return head_base_z + 0.25 * jnp.cos(head_ang)

    def step(self, params: HumanoidParams, state: base.EnvState, action):
        u = jnp.clip(action, -1.0, 1.0)
        model = self._model(params)
        q, qd = planar_step(
            model, state.qpos, state.qvel, u, self.dt, self._substeps
        )
        new_state = base.EnvState(qpos=q, qvel=qd, t=state.t + 1)

        standing = base.tolerance(
            self._head_height(q),
            lower=self._stand_height,
            upper=jnp.inf,
            margin=self._stand_height / 4.0,
        )
        torso_up = jnp.cos(q[2] + q[3])
        upright = base.tolerance(
            torso_up,
            lower=0.9,
            upper=jnp.inf,
            margin=1.9,
            sigmoid="linear",
            value_at_margin=0.0,
        )
        stand_reward = standing * upright
        small_control = jnp.mean(
            base.tolerance(
                u, margin=1.0, value_at_margin=0.0, sigmoid="quadratic"
            )
        )
        small_control = (4.0 + small_control) / 5.0
        if self._move_speed == 0.0:
            horizontal = jnp.abs(qd[0])
            dont_move = base.tolerance(horizontal, margin=2.0)
            reward = small_control * stand_reward * dont_move
        else:
            move = base.tolerance(
                qd[0],
                lower=self._move_speed,
                upper=jnp.inf,
                margin=self._move_speed,
                sigmoid="linear",
                value_at_margin=0.0,
            )
            move = (5.0 * move + 1.0) / 6.0
            reward = small_control * stand_reward * move
        return new_state, reward

    def observe(self, params: HumanoidParams, state: base.EnvState):
        return jnp.concatenate([state.qpos[1:], state.qvel])


class HumanoidStand(_Humanoid):
    name = "humanoid_stand"
    _move_speed = 0.0


class HumanoidWalk(_Humanoid):
    name = "humanoid_walk"
    _move_speed = 1.0
