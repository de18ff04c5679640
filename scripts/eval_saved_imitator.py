"""Evaluate a saved imitator run: many-episode pure-JAX eval + real
dm_control cross-eval.

Usage: python scripts/eval_saved_imitator.py <run_dir>
       [num_episodes=16] [dm_episodes=5] [--config fallback.yaml]

The policy/normalizer are rebuilt from the RUN DIR'S OWN config.json
(runners persist env + mpc + expert_prediction provenance), so a drifted
CLI yaml cannot skew the probe (ADVICE r3). ``--config`` supplies the
expert-predictor architecture only for runs saved before that field
existed. Reports mean/median/per-episode returns on the pure-JAX
imitator env and inside the actual dm_control suite task.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

# persistent compile cache (gan_mpc_tpu/runtime_setup.py)
from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.envs import make_env
from gan_mpc_tpu.envs.rollout import policy_rollout
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
    n_ep = int(args[1]) if len(args) > 1 else 16
    n_dm = int(args[2]) if len(args) > 2 else 5
    config = common.load_run_config(run_dir, fallback)

    env = make_env(config.env.name)
    trajs = common.ensure_trajectories(config)
    normalizer = common.build_normalizer(config, trajs)
    # GAN runs carry critic_params; L2 runs do not. Inspect the saved
    # checkpoint's structure directly (no try/except: a genuinely corrupt
    # file should fail loudly, not fall back to a mis-built policy).
    from gan_mpc_tpu.utils import serialization

    with open(run_dir + "/params.msgpack", "rb") as fp:
        raw = serialization.msgpack_restore(fp.read())
    with_critic = "critic_params" in raw
    policy, template = common.build_policy(
        config, env.obs_size, env.act_size, with_critic=with_critic
    )
    params = io.load_params(template, run_dir + "/params.msgpack")

    env_im, env_im_params = common.imitator_env(config)
    if n_ep <= 0:
        _dm_eval(config, policy, params, normalizer, n_dm)
        return
    ep = jax.jit(
        lambda key: policy_rollout(
            env_im,
            env_im_params,
            policy,
            params,
            normalizer,
            key,
            num_steps=config.mpc.evaluate.max_interactions,
            history=config.mpc.history,
            num_envs=n_ep,
        )
    )(jax.random.PRNGKey(123))
    rets = np.asarray(jnp.sum(ep.rewards, axis=-1))
    print(f"pure-JAX ({config.env.name}, {n_ep} eps): "
          f"mean {rets.mean():.1f} median {np.median(rets):.1f}")
    print("  per-episode:", np.sort(rets).round(1))

    if n_dm > 0:
        _dm_eval(config, policy, params, normalizer, n_dm)


def _dm_eval(config, policy, params, normalizer, n_dm):
    from gan_mpc_tpu.envs.dm_eval import (
        dm_control_available,
        evaluate_in_dm_control,
    )

    if not dm_control_available():
        print("dm_control not available; skipping cross-eval")
        return
    act = jax.jit(policy.act)

    def policy_fn(p, hx, hu):
        return act(p, hx, hu)

    mean_ret, per = evaluate_in_dm_control(
        config.env.name,
        policy_fn,
        params,
        normalizer,
        history=config.mpc.history,
        num_episodes=n_dm,
        max_steps=config.mpc.evaluate.max_interactions,
    )
    print(f"dm_control ({n_dm} eps): mean {mean_ret:.1f}")
    print("  per-episode:", np.round(sorted(per), 1))


if __name__ == "__main__":
    main()
