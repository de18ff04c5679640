"""Closed-loop probe of a saved run's EXPERT PREDICTOR alone.

Usage: python scripts/diag_predictor_closedloop.py <run_dir>
       [num_episodes=8] [--config fallback.yaml]

The policy is rebuilt from the run dir's own config.json (ADVICE r3);
``--config`` only supplies the expert arch for pre-round-4 runs.

Executes the predictor's own 1-step predicted action at every visited
state (pure behavior cloning, no MPC on top). This bounds what the MPC
layer has to work with: if the predictor cannot hold the behavior in
closed loop, neither can goal-tracking against its predictions
(cf. the pendulum diagnosis in BENCHMARKS.md, where this probe read 49
before DART collection and 837 after).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.envs import make_env
from gan_mpc_tpu.envs.rollout import episode_rollout
from gan_mpc_tpu.runners import common
from gan_mpc_tpu.utils import io


def main():
    args = sys.argv[1:]
    fallback = None
    if "--config" in args:
        i = args.index("--config")
        fallback = Config.from_yaml(args[i + 1])
        del args[i : i + 2]
    run_dir = args[0]
    n_ep = int(args[1]) if len(args) > 1 else 8
    config = common.load_run_config(run_dir, fallback)

    env = make_env(config.env.name)
    trajs = common.ensure_trajectories(config)
    normalizer = common.build_normalizer(config, trajs)
    from gan_mpc_tpu.utils import serialization

    with open(run_dir + "/params.msgpack", "rb") as fp:
        raw = serialization.msgpack_restore(fp.read())
    with_critic = "critic_params" in raw
    policy, template = common.build_policy(
        config, env.obs_size, env.act_size, with_critic=with_critic
    )
    params = io.load_params(template, run_dir + "/params.msgpack")

    def bc_policy(p, history_x, history_u):
        _, useq = policy.goals_and_warm_start(p, history_x)
        return useq[0]

    env_im, env_im_params = common.imitator_env(config)
    ep = jax.jit(
        jax.vmap(
            lambda key: episode_rollout(
                env_im,
                env_im_params,
                bc_policy,
                params,
                normalizer,
                key,
                num_steps=config.mpc.evaluate.max_interactions,
                history=config.mpc.history,
            )
        )
    )(jax.random.split(jax.random.PRNGKey(7), n_ep))
    rets = np.asarray(jnp.sum(ep.rewards, axis=-1))
    print(
        f"predictor-closed-loop ({config.env.name}, {n_ep} eps): "
        f"mean {rets.mean():.1f} median {np.median(rets):.1f}"
    )
    print("  per-episode:", np.sort(rets).round(1))


if __name__ == "__main__":
    main()
