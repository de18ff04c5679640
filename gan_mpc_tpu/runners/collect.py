"""Expert trajectory collection with scripted controllers.

The reference assumes an EXTERNAL RL pipeline writes
``expert_trajectories/{env}/trajectories.json`` (nothing in that repo
produces it — SURVEY.md §1). To make this framework self-contained, each
pure-JAX env ships a scripted expert (energy-shaping swingup, LQR-style
balance) good enough to clear the reference's >500-reward quality gate;
``collect_expert_trajectories`` rolls it out batched on device and returns
the reference-schema TrajectorySet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.data.trajectories import TrajectorySet


# Cheetah expert-variant selector (round-5 expert-quality scaling
# study): "nominal" = CEM-tuned on default physics (74.3/1000 nominal,
# 13.9 under the quality config's torso x3 shift); "shift3" = CEM-tuned
# WITH the torso x3 shift in the objective (25.2 under shift). Folded
# into EXPERT_VERSION below so the collection fingerprint separates the
# variants' trajectory stores.
import os as _os

_CHEETAH_VARIANT = _os.environ.get("GMT_CHEETAH_EXPERT", "nominal")

# Bump an env's entry whenever its scripted expert's BEHAVIOR changes —
# collection_fingerprint folds this in so cached trajectory stores
# labeled by an older expert are re-collected, not silently reused.
EXPERT_VERSION = {
    "pendulum_swingup": 2,
    "humanoid_walk": 3,
    "walker_walk": 2,  # v2: balance-only policy -> phase-PD walking gait
    # v2: open-loop CPG (~28) -> CEM-tuned state-indexed phase-PD gait
    # (74.3); closed-loop + DAgger-queryable like walker/humanoid
    "cheetah_run": (
        2 if _CHEETAH_VARIANT == "nominal" else f"2-{_CHEETAH_VARIANT}"
    ),
}


def scripted_expert(env):
    """Return ``policy_fn(params, history_x, history_u) -> action`` for the
    given env (params unused; histories are raw observations because
    collection runs with an identity normalizer)."""

    if env.name == "pendulum_swingup":
        p = env.default_params()
        m, r = p.body_mass_pole, p.geom_size_pole
        inertia = env.inertia(p)
        e_top = m * p.gravity * r

        def policy(params, history_x, history_u):
            del params, history_u
            cos_th, sin_th, thd = history_x[-1]
            energy = 0.5 * inertia * thd**2 + m * p.gravity * r * cos_th
            # gains grid-searched on the dm-exact physics: mean 844.6 /
            # worst-seed 694 over 16 seeds x 1000 steps.
            #
            # The 0.3*sin_th tie-break matters for the LABELS, not the
            # expert's own score (identical at any k in [1e-6, 1]):
            # near thd = 0 a velocity-sign pump direction flips with
            # noise, so behavior-cloned data carries BOTH +pump and
            # -pump labels at slow states and the goal predictor
            # averages them to ~zero — measured as the imitator's
            # slow-first-swingup failure band (BENCHMARKS.md round 3).
            # sign(thd + 0.3 sin_th) pumps where gravity is about to
            # accelerate the pendulum: a deterministic, physics-
            # consistent direction that makes the label function
            # unimodal in state.
            pump = 6.0 * (e_top - energy) * jnp.sign(thd + 0.3 * sin_th)
            th = jnp.arctan2(sin_th, cos_th)
            stabilize = -8.0 * th - 1.0 * thd
            near_top = jnp.abs(th) < 0.5
            u = jnp.where(near_top, stabilize, pump)
            return jnp.clip(jnp.array([u]) / p.torque_gain, -1.0, 1.0)

        return policy

    if env.name == "cartpole_balance":

        def policy(params, history_x, history_u):
            del params, history_u
            x, cos_th, sin_th, xd, thd = history_x[-1]
            th = jnp.arctan2(sin_th, cos_th)
            # hand-tuned stabilizing feedback around upright
            u = 18.0 * th + 3.0 * thd + 0.9 * x + 1.6 * xd
            return jnp.clip(jnp.array([u]), -1.0, 1.0)

        return policy

    if env.name == "walker_walk":
        w = jnp.asarray(_WALKER_WALK_PHASE)

        def policy(params, history_x, history_u):
            del params, history_u
            return walker_walk_phase_action(w, history_x[-1])

        return policy

    if env.name == "humanoid_stand":
        gains = jnp.asarray(_HUMANOID_STAND_GAINS)

        def policy(params, history_x, history_u):
            del params, history_u
            return humanoid_balance_policy(gains, history_x[-1], env)

        return policy

    if env.name == "humanoid_walk":
        w = jnp.asarray(_HUMANOID_WALK_PHASE)

        def policy(params, history_x, history_u):
            del params, history_u
            return humanoid_walk_phase_action(w, history_x[-1], env)

        return policy

    if env.name == "cheetah_run" and _CHEETAH_PD_W is not None:
        w = jnp.asarray(_CHEETAH_PD_W)

        def policy(params, history_x, history_u):
            del params, history_u
            return cheetah_pd_action(w, history_x[-1])

        return policy

    raise ValueError(f"no scripted expert for env {env.name!r}")


# Stand-balance feedback gains found by CEM over the differentiable
# engine (scripts/tune_humanoid_expert.py):
#   kp, kd, ank_e, ank_edot, hip_trunk_p, hip_trunk_d, waist_p, waist_d,
#   hip_e
_HUMANOID_STAND_GAINS = (
    0.45, 0.0032, -23.6043, 0.7678, 0.5925, 0.4468, -3.954, -0.4946,
    -0.8379,
)

# nominal stance: slight knee bend keeps the knees off their range
# boundary (range [-2, 0]); hips/ankles compensate to stay tall.
_HUMANOID_POSE = (
    0.0, 0.0, 0.08, -0.16, 0.08, 0.08, -0.16, 0.08, 0.0, 0.0, 0.0, 0.0
)


def humanoid_balance_policy(g, obs, env=None):
    """COM-over-feet balance controller for the planar humanoid.

    Two feedback loops on top of a nominal-pose PD: (1) ankle + hip
    torque regulates the horizontal offset of the whole-body center of
    mass from the foot support center — computed exactly via the engine's
    own forward kinematics from the observation (invariant to root x,
    which the observation omits); (2) hip + waist torque regulates the
    trunk's absolute pitch. Gains from CEM (scripts/tune_humanoid_expert).
    """
    if env is None:
        from gan_mpc_tpu.envs.humanoid import HumanoidStand

        env = HumanoidStand()
    from gan_mpc_tpu.envs.planar import contact_points, forward_kinematics

    model = env._model(env.default_params())

    def com_minus_feet(q):
        _, _, coms = forward_kinematics(model, q)
        com_x = jnp.sum(model.mass * coms[:, 0]) / jnp.sum(model.mass)
        feet_x = jnp.mean(contact_points(model, q)[:4, 0])
        return com_x - feet_x

    q = jnp.concatenate([jnp.zeros(1, obs.dtype), obs[:14]])
    qd = obs[14:29]
    e, edot = jax.jvp(com_minus_feet, (q,), (qd,))

    pitch, pitchd = obs[1], obs[16]
    joints, jointsd = obs[2:14], obs[17:29]
    trunk = pitch + joints[0]  # absolute torso angle
    trunkd = pitchd + jointsd[0]
    u = -g[0] * (joints - jnp.asarray(_HUMANOID_POSE)) - g[1] * jointsd
    bal = g[2] * e + g[3] * edot
    u = u.at[4].add(bal).at[7].add(bal)
    hip = g[4] * trunk + g[5] * trunkd + g[8] * e
    u = u.at[2].add(hip).at[5].add(hip)
    u = u.at[0].add(g[6] * trunk + g[7] * trunkd)
    return jnp.clip(u, -1.0, 1.0)


# PD-tracked kinematic walking gait for the planar humanoid, found by
# warm-started CEM over the differentiable engine at full episode length
# (scripts/tune_humanoid_walk.py --pd --steps 1000). A phase-indexed
# joint-angle cycle (antiphase hip sin, rectified swing-knee flexion,
# ankle push-off, arms antiphase) is tracked by per-joint PD loops whose
# stiffness is itself tuned, on top of the stand balance blend + a
# speed-servoed forward lean. Measured: 842.7/1000 on the CEM seeds,
# 667.5/1000 mean over 16 fresh seeds — clears the reference's >500
# expert gate (/root/reference/data_loader.py:25-27).
# w = [freq, lean, bal, A_hip, A_knee, ph_knee, A_ank, ph_ank, A_arm,
#      kp_leg, kd_leg, k_v, v_ref]
_HUMANOID_WALK_PD = (
    1.8214, 0.798, 0.6853, -0.131, -1.009, 1.2864, -0.3145, -0.2525,
    0.9285, 3.0463, 0.0291, -0.1376, 1.1113,
)
_WALK_QIDX = tuple(range(3, 15))  # actuated hinge q indices


def _walk_pd_targets(w, ph):
    """Phase -> 12 joint-angle targets for the walking cycle."""
    A_h, A_k, ph_k, A_a, ph_a, A_arm = w[3], w[4], w[5], w[6], w[7], w[8]
    s_l, s_r = jnp.sin(ph), jnp.sin(ph + jnp.pi)
    hip_l, hip_r = A_h * s_l, A_h * s_r
    # rectified swing-leg knee flexion (knee range is [-2, 0])
    knee_l = -A_k * jnp.maximum(jnp.sin(ph + ph_k), 0.0)
    knee_r = -A_k * jnp.maximum(jnp.sin(ph + jnp.pi + ph_k), 0.0)
    ank_l = A_a * jnp.sin(ph + ph_a)
    ank_r = A_a * jnp.sin(ph + jnp.pi + ph_a)
    sho_l, sho_r = -A_arm * s_l, -A_arm * s_r
    z = jnp.zeros(())
    return jnp.stack(
        [z, z, hip_l, knee_l, ank_l, hip_r, knee_r, ank_r,
         sho_l, z, sho_r, z]
    )


def humanoid_walk_action(obs: jax.Array, t: jax.Array, dt: float, env=None):
    """Scripted humanoid walking expert: PD-tracked gait cycle over the
    balance blend (state + time indexed)."""
    w = jnp.asarray(_HUMANOID_WALK_PD)
    lean, bal = w[1], w[2]
    kp, kd = jnp.abs(w[9]), jnp.abs(w[10])
    k_v, v_ref = w[11], w[12]
    q = jnp.concatenate([jnp.zeros(1, obs.dtype), obs[:14]])
    qd = obs[14:]
    vx = qd[0]
    ph = 2.0 * jnp.pi * w[0] * t * dt
    qt = _walk_pd_targets(w, ph)
    qidx = jnp.asarray(_WALK_QIDX)
    u_pd = kp * (qt - q[qidx]) - kd * qd[qidx]
    u = bal * humanoid_balance_policy(
        jnp.asarray(_HUMANOID_STAND_GAINS), obs, env
    ) + u_pd
    u = u.at[0].add(-(lean + k_v * (v_ref - vx)))
    return jnp.clip(u, -1.0, 1.0)


# STATE-INDEXED walking expert (expert v3): the same PD-tracked kinematic
# cycle, but the gait phase is estimated FROM THE OBSERVATION by matching
# the full 12-joint pose (and velocity) against the cycle — never from
# wall-clock time. Why this matters: a time-indexed expert's action is
# not a function of state, so behavior cloning of it is ill-posed
# (measured: closed-loop BC 23.6/1000 vs the expert's 667.5) and DAgger
# cannot query it from arbitrary restart states. This expert is
# memoryless — BC is well-posed and DAgger restarts work — and scores
# HIGHER than the time-indexed gait (tuned by warm-started CEM,
# scripts/tune_walk_phase.py --match).
# w = [freq, lean, bal, A_hip, A_knee, ph_knee, A_ank, ph_ank, A_arm,
#      kp_leg, kd_leg, k_v, v_ref, delta (phase lead), lam (vel weight)]
_HUMANOID_WALK_PHASE = (
    1.9790, 0.8104, 0.5662, -0.1909, -0.7046, 1.3727, -0.3198, -0.2791,
    1.1607, 2.4502, 0.0245, -0.1714, 0.7430, 0.3880, 0.0010,
)
_PHASE_GRID = np.linspace(-np.pi, np.pi, 64, endpoint=False)


def walk_phase_from_pose(w, q_joints, qd_joints):
    """Grid argmin over phase of ||qt(ph) - q||^2 + lam ||omega qt'(ph)
    - qd||^2 — on the walking limit cycle the pose determines the phase
    almost everywhere, and the velocity term breaks mirror-crossing
    ties. At standstill every phase ties and argmin's first-index rule
    plus the phase lead delta kicks off the first step."""
    w = jnp.asarray(w)
    lam = jnp.abs(w[14])
    omega = 2.0 * jnp.pi * w[0]
    grid = jnp.asarray(_PHASE_GRID, q_joints.dtype)
    qts = jax.vmap(lambda p: _walk_pd_targets(w, p))(grid)
    qdts = (
        jax.vmap(jax.jacfwd(lambda p: _walk_pd_targets(w, p)))(grid) * omega
    )
    err = jnp.sum((qts - q_joints) ** 2, axis=-1) + lam * jnp.sum(
        (qdts - qd_joints) ** 2, axis=-1
    )
    return grid[jnp.argmin(err)]


def humanoid_walk_phase_action(w, obs: jax.Array, env=None) -> jax.Array:
    """Memoryless walking expert: PD-track the gait cycle at the
    pose-matched phase (+ lead), over the stand-balance blend with a
    speed-servoed forward lean — same structure as the time-indexed
    ``humanoid_walk_action`` with the clock replaced by state."""
    w = jnp.asarray(w)
    lean, bal = w[1], w[2]
    kp, kd = jnp.abs(w[9]), jnp.abs(w[10])
    k_v, v_ref, delta = w[11], w[12], w[13]
    q = jnp.concatenate([jnp.zeros(1, obs.dtype), obs[:14]])
    qd = obs[14:]
    vx = qd[0]
    joints, jointsd = obs[2:14], obs[17:29]
    ph = walk_phase_from_pose(w, joints, jointsd) + delta
    qt = _walk_pd_targets(w, ph)
    qidx = jnp.asarray(_WALK_QIDX)
    u_pd = kp * (qt - q[qidx]) - kd * qd[qidx]
    u = bal * humanoid_balance_policy(
        jnp.asarray(_HUMANOID_STAND_GAINS), obs, env
    ) + u_pd
    u = u.at[0].add(-(lean + k_v * (v_ref - vx)))
    return jnp.clip(u, -1.0, 1.0)


# STATE-INDEXED walker_walk expert: the same memoryless phase-PD gait
# design as the humanoid's expert v3 — antiphase hip sin, rectified
# swing-knee flexion, ankle push-off, torso-pitch balance + speed servo
# through the hips — with the gait phase estimated by FULL-POSE MATCHING
# against the kinematic cycle (the expert-v3 estimator; the hip-pair
# atan2 variant plateaued at 583 where this reaches 872.9/1000 — CEM
# over the differentiable engine, scripts/tune_walker_walk.py --match).
# w = [freq, A_hip, A_knee, ph_knee, A_ank, ph_ank, kp, kd, k_pitch,
#      k_pitchd, k_v, v_ref, delta, lam]
_WALKER_WALK_PHASE = (
    -0.0552, 0.6620, -0.7798, -0.0775, 0.5858, -1.1868, 2.9690, -0.0028,
    5.0975, 0.2397, 0.2843, 1.4972, 1.9741, -0.0349,
)


def _walker_targets(w, ph):
    A_h, A_k, ph_k, A_a, ph_a = w[1], w[2], w[3], w[4], w[5]
    s_l, s_r = jnp.sin(ph), jnp.sin(ph + jnp.pi)
    knee_l = -A_k * jnp.maximum(jnp.sin(ph + ph_k), 0.0)
    knee_r = -A_k * jnp.maximum(jnp.sin(ph + jnp.pi + ph_k), 0.0)
    ank_l = A_a * jnp.sin(ph + ph_a)
    ank_r = A_a * jnp.sin(ph + jnp.pi + ph_a)
    return jnp.stack([A_h * s_l, knee_l, ank_l, A_h * s_r, knee_r, ank_r])


def walker_walk_phase_action(w, obs: jax.Array) -> jax.Array:
    """Memoryless walker gait (see scripts/tune_walker_walk.py). obs =
    [z, pitch, 6 joints, xd, zd, pitchd, 6 jointds] (envs/walker.py)."""
    w = jnp.asarray(w)
    kp, kd = jnp.abs(w[6]), jnp.abs(w[7])
    k_p, k_pd, k_v, v_ref, delta = w[8], w[9], w[10], w[11], w[12]
    lam = jnp.abs(w[13])
    pitch = obs[1]
    joints = obs[2:8]  # lhip lknee lank rhip rknee rank
    vx, pitchd = obs[8], obs[10]
    jointsd = obs[11:17]
    omega = 2.0 * jnp.pi * w[0]
    grid = jnp.asarray(_PHASE_GRID, obs.dtype)
    qts = jax.vmap(lambda p: _walker_targets(w, p))(grid)
    qdts = (
        jax.vmap(jax.jacfwd(lambda p: _walker_targets(w, p)))(grid) * omega
    )
    err = jnp.sum((qts - joints) ** 2, axis=-1) + lam * jnp.sum(
        (qdts - jointsd) ** 2, axis=-1
    )
    ph = grid[jnp.argmin(err)] + delta
    qt = _walker_targets(w, ph)
    u = kp * (qt - joints) - kd * jointsd
    hip = k_p * pitch + k_pd * pitchd - k_v * (v_ref - vx)
    u = u.at[0].add(hip).at[3].add(hip)
    return jnp.clip(u, -1.0, 1.0)


# STATE-INDEXED cheetah_run expert (EXPERT_VERSION 2): the same
# memoryless phase-PD design as the walker/humanoid experts — per-joint
# sinusoidal joint-angle targets tracked by PD, phase recovered from the
# observation by full-pose matching, pitch feedback through the thighs,
# speed servo. CEM-tuned over the differentiable engine by
# scripts/tune_cheetah_pd.py; set to that run's printed ``w =`` vector.
# None => the open-loop CPG below remains the cheetah expert (v1).
# Round-5 CEM (40 iters, pop 64, 16 seeds x 1000 steps): 74.3/1000
# vs the open-loop CPG's ~28 (runs/r5_cheetah_cem.log).
_CHEETAH_PD_W_NOMINAL = [
    4.4399, 0.7766, 0.1664, 0.6158, 0.2430, 0.4822, 0.4537, -0.1115,
    0.8024, 0.2871, 2.3145, 4.0082, 3.4129, -0.2521, 0.1118, -0.8263,
    -0.0015, -0.2373, -0.4679, 2.9426, 0.2765, 2.6832, 0.5018, 0.3891,
    2.3996, 0.2229, -0.1315,
]
# --shift-torso 3.0 CEM continuation of the nominal vector (25.2/1000
# UNDER the shift vs the nominal gait's 13.9 there; see
# runs/r5_cheetah_cem_shifted.log).
_CHEETAH_PD_W_SHIFT3 = [
    4.3872, 1.1501, 0.0224, 0.7340, 0.2481, 0.5644, 0.5884, -0.4845,
    0.8556, 0.2607, 1.1576, 4.1905, 3.3727, -0.1481, -0.1347, -0.9588,
    0.2874, -0.0683, -0.2184, 5.4376, 0.3975, 2.3777, 0.6126, 0.1848,
    1.8013, -0.4503, -0.1062,
]
_CHEETAH_PD_W = (
    _CHEETAH_PD_W_SHIFT3
    if _CHEETAH_VARIANT == "shift3"
    else _CHEETAH_PD_W_NOMINAL
)

# numpy, NOT jnp: importing a module must not initialize a JAX backend
# (a module-level jnp call would, before the caller configures JAX).
_CHEETAH_PHASE_GRID = np.linspace(-np.pi, np.pi, 64, endpoint=False)


def _cheetah_targets(w, ph):
    A, phi, mid = w[1:7], w[7:13], w[13:19]
    return mid + A * jnp.sin(ph + phi)


def cheetah_pd_action(w, obs: jax.Array) -> jax.Array:
    """Memoryless cheetah gait (see scripts/tune_cheetah_pd.py). obs =
    [z, pitch, 6 joints, xd, zd, pitchd, 6 jointds] (envs/cheetah.py)."""
    kp, kd = jnp.abs(w[19]), jnp.abs(w[20])
    k_p, k_pd, k_v, v_ref = w[21], w[22], w[23], w[24]
    delta, lam = w[25], jnp.abs(w[26])
    pitch = obs[1]
    joints = obs[2:8]
    vx, pitchd = obs[8], obs[10]
    jointsd = obs[11:17]
    omega = 2.0 * jnp.pi * w[0]
    grid = jnp.asarray(_CHEETAH_PHASE_GRID, dtype=jnp.float32)
    qts = jax.vmap(lambda p: _cheetah_targets(w, p))(grid)
    qdts = jax.vmap(jax.jacfwd(lambda p: _cheetah_targets(w, p)))(grid) * omega
    err = jnp.sum((qts - joints) ** 2, axis=-1) + lam * jnp.sum(
        (qdts - jointsd) ** 2, axis=-1
    )
    ph = grid[jnp.argmin(err)] + delta
    qt = _cheetah_targets(w, ph)
    u = kp * (qt - joints) - kd * jointsd
    corr = k_p * pitch + k_pd * pitchd - k_v * (v_ref - vx)
    u = u.at[0].add(corr).at[3].add(corr)
    return jnp.clip(u, -1.0, 1.0)


# Open-loop CPG gait for cheetah_run, found by on-device evolution search
# over the differentiable planar engine (mean forward speed ~2.4 m/s).
# u_i(t) = tanh(amp_i sin(2 pi f t dt + phase_i) + offset_i).
_CHEETAH_GAIT = np.array(
    [3.0599, 1.6547, 2.6491, 1.3525, 2.2158, 2.275, 0.9197,
     2.4828, 0.0499, -0.304, 2.7068, 3.477, 5.3848, 1.05,
     0.1363, -1.0107, -0.4368, -0.5142, 0.8856]
)


def cheetah_gait_action(t: jax.Array, dt: float) -> jax.Array:
    vec = jnp.asarray(_CHEETAH_GAIT)
    freq = 1.0 + 3.0 * jax.nn.sigmoid(vec[0])
    amp, phase, offset = vec[1:7], vec[7:13], vec[13:19]
    ph = 2.0 * jnp.pi * freq * t * dt
    return jnp.tanh(amp * jnp.sin(ph + phase) + offset)


def _collect_open_loop(
    env, env_params, num_trajectories, key, num_steps, noise_sigma=0.1,
    action_fn=None,
):
    """Collection for time-indexed experts (cheetah gait, humanoid walk).

    ``action_fn(obs, t) -> u`` defaults to the cheetah gait. Same
    DART-style noise injection as the closed-loop path: the EXECUTED
    action carries exploration noise while the LOGGED action is the clean
    gait command. Without it the logged transitions are a deterministic
    function of time and the learned dynamics cannot identify the action
    channel (the round-1 pendulum lesson, BENCHMARKS.md quality ladder)."""
    if action_fn is None:
        action_fn = lambda obs, t: cheetah_gait_action(t, env.dt)

    def one(k):
        k_reset, k_noise = jax.random.split(k)
        s0 = env.reset(env_params, k_reset)

        def body(s, inp):
            t, kk = inp
            obs = env.observe(env_params, s)
            u = action_fn(obs, t)
            u_exec = jnp.clip(
                u + noise_sigma * jax.random.normal(kk, u.shape), -1.0, 1.0
            )
            s, r = env.step(env_params, s, u_exec)
            return s, (obs, u, u_exec, r)

        _, (xs, us, ues, rs) = jax.lax.scan(
            body,
            s0,
            (jnp.arange(num_steps), jax.random.split(k_noise, num_steps)),
        )
        return xs, us, ues, rs

    xs, us, ues, rs = jax.jit(
        lambda ks: jax.vmap(one)(ks)
    )(jax.random.split(key, num_trajectories))
    return TrajectorySet(
        states=np.asarray(xs),
        actions=np.asarray(us),
        rewards=np.asarray(rs),
        executed_actions=np.asarray(ues),
    )


def collect_expert_trajectories(
    env,
    num_trajectories: int,
    key: jax.Array,
    num_steps: int = 1000,
    env_params=None,
    noise_sigma: float = 0.25,
    reset_velocity_sigma: float = 0.0,
) -> TrajectorySet:
    """Batched on-device rollout of the scripted expert.

    ``noise_sigma > 0`` enables DART-style noise injection: the EXECUTED
    action is the expert's plus exploration noise, while the LOGGED action
    is the expert's clean corrective action at the visited state. This
    covers the neighborhoods of the expert manifold with corrective
    labels, which is what makes the downstream expert-prediction model
    stable in closed loop (measured on pendulum: closed-loop return 49 ->
    837 of the scripted expert's 840).
    """
    env_params = env_params if env_params is not None else env.default_params()
    if env.name == "cheetah_run" and _CHEETAH_PD_W is None:
        # v1 open-loop CPG; the state-indexed v2 PD gait (when tuned)
        # takes the closed-loop path below like walker/humanoid.
        return _collect_open_loop(
            env,
            env_params,
            num_trajectories,
            key,
            num_steps,
            noise_sigma=noise_sigma,
        )
    # (humanoid_walk routed through _collect_open_loop when its expert
    # was time-indexed — expert v3 is state-indexed and takes the
    # closed-loop path below, which is also what makes DAgger restarts
    # possible for it)
    policy = scripted_expert(env)

    def one(k):
        k_reset, k_vel, k_noise = jax.random.split(k, 3)
        s0 = env.reset(env_params, k_reset)
        if reset_velocity_sigma > 0.0:
            # start some episodes mid-motion: the scripted experts are
            # universal controllers, so this records corrective behavior
            # at off-manifold phases (e.g. slow oscillation through the
            # pendulum's bottom) that pure rest starts never visit —
            # exactly where closed-loop imitators otherwise get stuck.
            s0 = s0.replace(
                qvel=s0.qvel
                + reset_velocity_sigma
                * jax.random.normal(k_vel, s0.qvel.shape)
            )

        def body(s, kk):
            obs = env.observe(env_params, s)
            u_clean = policy(None, obs[None], None)
            u_exec = jnp.clip(
                u_clean
                + noise_sigma * jax.random.normal(kk, u_clean.shape),
                -1.0,
                1.0,
            )
            s, r = env.step(env_params, s, u_exec)
            return s, (obs, u_clean, u_exec, r)

        _, (xs, us, ues, rs) = jax.lax.scan(
            body, s0, jax.random.split(k_noise, num_steps)
        )
        return xs, us, ues, rs

    xs, us, ues, rs = jax.jit(lambda ks: jax.vmap(one)(ks))(
        jax.random.split(key, num_trajectories)
    )
    return TrajectorySet(
        states=np.asarray(xs),
        actions=np.asarray(us),
        rewards=np.asarray(rs),
        executed_actions=np.asarray(ues),
    )


def collect_dagger_trajectories(
    env,
    env_params,
    policy,
    policy_params,
    normalizer,
    key: jax.Array,
    num_segments: int = 64,
    segment_steps: int = 120,
    policy_steps: int = 1000,
    policy_episodes: int = 8,
    noise_sigma: float = 0.25,
    history: int = 1,
    imitator_env=None,
    imitator_env_params=None,
    state_weighting: str = "uniform",
    weight_power: float = 2.0,
    weight_floor: float = 0.05,
) -> TrajectorySet:
    """DAgger-style corrective expert data (framework extension; the
    reference has no on-policy expert refresh — its predictor sees only
    the external expert's visitation).

    The failure mode this closes: the expert predictor generates the
    planner's goals, and on states the IMITATOR visits but the expert
    never does (post-fall capture, slow oscillation), those goals are
    garbage — goal generation, not dynamics error, was measured as the
    dominant quality loss (BENCHMARKS.md). Because the scripted experts
    are universal controllers, we can query them anywhere: roll the
    current imitator policy, sample states it actually visits, RESTART
    the scripted expert from exactly those states (same qpos/qvel), and
    log its corrective segments with the usual DART noise split (clean
    logged / noisy executed).

    Policy rollouts run in the IMITATOR env (where the policy acts);
    expert segments run in the EXPERT env (where demonstrations live).
    Everything is batched and jitted; returns the reference-schema
    TrajectorySet whose windows merge into the predictor's dataset.
    """
    from gan_mpc_tpu.envs import base as env_base
    from gan_mpc_tpu.envs.rollout import policy_rollout

    k_roll, k_pick, k_noise = jax.random.split(key, 3)
    ienv = imitator_env if imitator_env is not None else env
    iparams = (
        imitator_env_params if imitator_env_params is not None else env_params
    )
    episode = policy_rollout(
        ienv,
        iparams,
        policy,
        policy_params,
        normalizer,
        k_roll,
        num_steps=policy_steps,
        history=history,
        num_envs=policy_episodes,
    )
    nq = episode.qpos.shape[-1]
    qpos = jnp.reshape(episode.qpos, (-1, nq))
    qvel = jnp.reshape(episode.qvel, (-1, nq))
    if state_weighting == "reward_weighted":
        # Focus the expert's corrective segments on the states where the
        # policy is doing WORST. Uniform sampling over 1000-step episodes
        # is dominated by the post-capture balanced band (reward ~1);
        # the measured residual failure (BENCHMARKS.md round-3 ladder) is
        # slow first swingup from near-hanging states (reward ~0), so
        # weight each visited state by (1 - reward)^p + floor. dm-suite
        # rewards live in [0, 1]; the floor keeps a trickle of easy-band
        # segments so the refreshed predictor doesn't forget capture.
        r = jnp.clip(jnp.reshape(episode.rewards, (-1,)), 0.0, 1.0)
        w = (1.0 - r) ** weight_power + weight_floor
        idx = jax.random.choice(
            k_pick,
            qpos.shape[0],
            shape=(num_segments,),
            replace=False,
            p=w / jnp.sum(w),
        )
    else:
        idx = jax.random.choice(
            k_pick, qpos.shape[0], shape=(num_segments,), replace=False
        )
    expert = scripted_expert(env)

    def seg(q, qd, k):
        s0 = env_base.EnvState(
            qpos=q.astype(jnp.float32),
            qvel=qd.astype(jnp.float32),
            t=jnp.int32(0),
        )

        def body(s, kk):
            obs = env.observe(env_params, s)
            u_clean = expert(None, obs[None], None)
            u_exec = jnp.clip(
                u_clean + noise_sigma * jax.random.normal(kk, u_clean.shape),
                -1.0,
                1.0,
            )
            s, r = env.step(env_params, s, u_exec)
            return s, (obs, u_clean, u_exec, r)

        _, (xs, us, ues, rs) = jax.lax.scan(
            body, s0, jax.random.split(k, segment_steps)
        )
        return xs, us, ues, rs

    xs, us, ues, rs = jax.jit(
        lambda q, qd, ks: jax.vmap(seg)(q, qd, ks)
    )(qpos[idx], qvel[idx], jax.random.split(k_noise, num_segments))
    return TrajectorySet(
        states=np.asarray(xs),
        actions=np.asarray(us),
        rewards=np.asarray(rs),
        executed_actions=np.asarray(ues),
    )
