"""Diagnostic: planning horizon vs the true-physics performance ceiling.

Round 1 measured that MPC planning through the TRUE (differentiable)
pendulum physics with expert-predictor goals returns only ~538/840 at
horizon 5 — i.e. the ceiling is NOT dynamics-model error alone; the
(horizon, expert-goal) combination caps returns. This script quantifies
that ceiling across horizons/iteration caps so the quality configs can be
retuned now that the planner is 3.3x faster.

Usage: python scripts/diag_horizon_ceiling.py [config]
"""

import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

# persistent compile cache (gan_mpc_tpu/runtime_setup.py)
from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.data.normalizer import Normalizer  # noqa: F401
from gan_mpc_tpu.envs import make_env
from gan_mpc_tpu.envs.rollout import batched_rollout
from gan_mpc_tpu.models.cost import MPCCost, CostFeatureNet
from gan_mpc_tpu.planner import SolverSettings, make_implicit_planner
from gan_mpc_tpu.runners import common


def true_dynamics_obs(env, env_params):
    """True pendulum physics as planner dynamics over the OBSERVATION
    state [cos th, sin th, thd] (normalized space handled by caller)."""

    def f(x, u, t):
        del t
        cos_th, sin_th, thd = x[0], x[1], x[2]
        th = jnp.arctan2(sin_th, cos_th)
        m, r = env_params.body_mass_pole, env_params.geom_size_pole
        inertia = env.inertia(env_params)
        torque = (
            env_params.torque_gain * jnp.clip(u[0], -1.0, 1.0)
            + m * env_params.gravity * r * jnp.sin(th)
        )
        thd_n = (thd + env.dt * torque / inertia) / (
            1.0 + env.dt * env_params.damping / inertia
        )
        th_n = th + env.dt * thd_n
        return jnp.array([jnp.cos(th_n), jnp.sin(th_n), thd_n])

    return f


def main():
    cfg_path = sys.argv[1] if len(sys.argv) > 1 else (
        "configs/gan_pendulum_quality.yaml"
    )
    config = Config.from_yaml(cfg_path)
    env = make_env(config.env.name)
    trajs = common.ensure_trajectories(config)
    normalizer = common.build_normalizer(config, trajs)

    # train the expert predictor exactly as the runners do
    from gan_mpc_tpu.runners import expert as expert_runner

    out = expert_runner.run(config, log_fn=lambda s: print("  " + s))
    expert_params = out["params"]
    model = common.build_expert_model(config, env.obs_size, env.act_size)

    env_params = env.default_params()
    mu_x, sd_x = normalizer.state_mean, normalizer.state_std

    results = {}
    for horizon in (5, 10, 20, 40):
        for iters in (10, 30):
            cost_model = MPCCost(
                CostFeatureNet(hidden=(16,), features_out=4), horizon
            )
            weights = jnp.asarray((-2.0, 3.0, -20.0))  # terminal ~0

            f_raw = true_dynamics_obs(env, env_params)

            def dyn(x, u, t, theta):
                # planner works in normalized obs space
                raw = f_raw(x * sd_x + mu_x, u, t)
                return (raw - mu_x) / sd_x

            def stage(x, u, t, theta, goal_X):
                return cost_model.stage(x, u, t, theta["w"], goal_X)

            settings = SolverSettings(max_iterations=iters)
            plan = make_implicit_planner(stage, dyn, settings)

            def act(params, history_x, history_u):
                carry = model.warm_carry(expert_params, history_x)
                goal_X, init_U = model.generate(
                    expert_params, carry, horizon
                )
                sol = plan(
                    {"w": weights}, history_x[-1], init_U, (goal_X,), ()
                )
                return sol.U[0]

            ep = jax.jit(
                lambda k: batched_rollout(
                    env,
                    env_params,
                    act,
                    {},
                    normalizer,
                    k,
                    num_steps=1000,
                    history=1,
                    num_envs=3,
                )
            )(jax.random.PRNGKey(7))
            ret = float(jnp.mean(jnp.sum(ep.rewards, axis=-1)))
            results[(horizon, iters)] = ret
            print(f"H={horizon:3d} iters={iters:3d}: return {ret:7.1f}")

    print("\nsummary:", results)


if __name__ == "__main__":
    main()
