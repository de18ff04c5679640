"""Evaluate policies in the REAL dm_control environments (oracle path).

The reference measures rewards by rolling its policy in dm_control
(``/root/reference/utils.py:254-306``). This framework trains and
evaluates entirely in its pure-JAX envs; this module closes the parity
loop by re-evaluating any trained policy inside the actual MuJoCo suite
task — same observation flattening (``/root/reference/utils.py:103-108``)
and episode protocol — so reward numbers are directly comparable to
anything the reference could produce. Host-side and import-guarded:
dm_control is an optional oracle, never a runtime dependency.
"""

from __future__ import annotations

import numpy as np

_SUITE_NAMES = {
    "pendulum_swingup": ("pendulum", "swingup"),
    "cartpole_balance": ("cartpole", "balance"),
    "cheetah_run": ("cheetah", "run"),
    "walker_walk": ("walker", "walk"),
}

# The repo's humanoid is PLANAR (13 links, 29-dim obs); dm_control's
# humanoid is 3-D with a 67-dim observation in a different layout — a
# cross-eval would crash on normalizer shapes or produce meaningless
# numbers, so these names are explicitly unsupported.
_NO_COUNTERPART = {"humanoid_stand", "humanoid_walk"}


def dm_control_available() -> bool:
    try:
        import dm_control.suite  # noqa: F401

        return True
    except Exception:
        return False


def has_dm_counterpart(env_name: str) -> bool:
    """True when the env maps onto a real dm_control suite task (the
    planar humanoid does not; see _NO_COUNTERPART)."""
    return env_name in _SUITE_NAMES


def apply_suite_physics_shift(env, shifts) -> None:
    """Mutate a loaded dm_control env's MuJoCo model in place with the
    same multiplier schema as the pure-JAX envs' ``apply_physics_shift``
    — the reference's imitator domain-shift mechanism
    (``/root/reference/utils.py:43-62``): ``body_mass_<name>`` /
    ``geom_size_<name>`` / ``jnt_stiffness_<name>`` multiply the named
    model entry."""
    import re

    for kv in shifts or []:
        key, value = kv["key"], float(kv["value"])
        for pattern, field in (
            ("^body_mass_(.*)$", "body_mass"),
            ("^geom_size_(.*)$", "geom_size"),
            ("^jnt_stiffness_(.*)$", "jnt_stiffness"),
        ):
            m = re.search(pattern, key)
            if m:
                getattr(env.physics.named.model, field)[m.group(1)] *= value
                break
        else:
            raise ValueError(f"unsupported physics-shift key {key!r}")


def _walker_obs(physics) -> np.ndarray:
    """dm_control walker state -> the planar walker's 17-dim obs layout.

    The suite's observation dict (orientations 14 + height + velocity 9
    = 24) doesn't match the planar walker's [qpos[1:], qvel] layout, but
    the underlying state does up to a joint permutation: dm qpos is
    [rootz, rootx, rooty, R(hip,knee,ankle), L(hip,knee,ankle)] vs ours
    [x, z, pitch, L..., R...]."""
    q = np.asarray(physics.data.qpos)
    v = np.asarray(physics.data.qvel)
    perm = [1, 0, 2, 6, 7, 8, 3, 4, 5]
    q2, v2 = q[perm], v[perm]
    return np.concatenate([q2[1:], v2])


# env families whose suite observation layout differs from the pure-JAX
# env's: build the policy's observation from the physics state instead.
_OBS_ADAPTERS = {"walker_walk": _walker_obs}


def flatten_observation(obs_dict) -> np.ndarray:
    """dict-of-arrays -> flat vector, the reference's flattening
    (``/root/reference/utils.py:103-108``: concatenate values in dict
    order, scalars promoted)."""
    parts = []
    for v in obs_dict.values():
        parts.append(np.atleast_1d(np.asarray(v, dtype=np.float64)))
    return np.concatenate(parts)


def evaluate_in_dm_control(
    env_name: str,
    policy_fn,
    params,
    normalizer,
    history: int = 1,
    num_episodes: int = 3,
    max_steps: int = 1000,
    seed: int = 0,
    physics_shifts=None,
):
    """Roll ``policy_fn(params, history_x, history_u) -> action`` in the
    dm_control suite task; returns (mean_return, per_episode_returns).

    ``policy_fn`` sees NORMALIZED observations and emits raw actions, the
    same contract as the pure-JAX rollouts (envs/rollout.py), so a policy
    trained in this framework drops in unchanged. ``physics_shifts``
    applies the imitator domain shift to the SUITE env too, so the
    cross-eval measures the same (shifted) task the policy was trained
    for — exactly the reference's protocol
    (``/root/reference/norm/runner.py:240-247`` evaluates in
    ``get_dm_imitator_env``).
    """
    import jax.numpy as jnp
    from dm_control import suite

    if env_name in _NO_COUNTERPART:
        raise ValueError(
            f"{env_name}: no dm_control counterpart — the repo's humanoid "
            "is planar (29-dim obs); the suite humanoid is 3-D (67-dim)."
        )
    domain, task = _SUITE_NAMES[env_name]
    adapter = _OBS_ADAPTERS.get(env_name)

    def observe(env, ts):
        if adapter is not None:
            return adapter(env.physics)
        return flatten_observation(ts.observation)

    returns = []
    for ep in range(num_episodes):
        env = suite.load(
            domain, task, task_kwargs={"random": seed + ep}
        )
        apply_suite_physics_shift(env, physics_shifts)
        ts = env.reset()
        obs = observe(env, ts)
        hx = [normalizer.normalize_state(jnp.asarray(obs, jnp.float32))] * (
            history + 1
        )
        hu = [jnp.zeros(env.action_spec().shape, jnp.float32)] * history
        total = 0.0
        for _ in range(max_steps):
            u = policy_fn(
                params,
                jnp.stack(hx[-(history + 1) :]),
                jnp.stack(hu[-history:]),
            )
            u = np.asarray(u, dtype=np.float64)
            ts = env.step(u)
            total += float(ts.reward or 0.0)
            obs = observe(env, ts)
            hx.append(
                normalizer.normalize_state(jnp.asarray(obs, jnp.float32))
            )
            hu.append(jnp.asarray(u, jnp.float32))
            if ts.last():
                break
        returns.append(total)
    return float(np.mean(returns)), returns
