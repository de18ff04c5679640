"""Diagnose WHERE a trained pendulum imitator loses reward.

Rolls the saved policy over a wide batch of episodes (one compiled
batched rollout) and reports per-episode: start angle, return, time of
first sustained capture (50 consecutive steps with |theta| < 0.3),
number of falls after capture, and steps spent upright. The failure
taxonomy feeds the quality recipe (BENCHMARKS.md): slow first swingup
vs repeated falls are different fixes (rest-state goal quality vs
capture-band goals).

Usage: python scripts/diag_pendulum_failures.py <config.yaml> <run_dir>
       [episodes=64]
"""

import sys

import jax
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
    cfg_path, run_dir = sys.argv[1], sys.argv[2]
    n_ep = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    config = Config.from_yaml(cfg_path)

    env = make_env(config.env.name)
    trajs = common.ensure_trajectories(config)
    normalizer = common.build_normalizer(config, trajs)
    from gan_mpc_tpu.utils import serialization

    with open(run_dir + "/params.msgpack", "rb") as fp:
        raw = serialization.msgpack_restore(fp.read())
    policy, template = common.build_policy(
        config, env.obs_size, env.act_size,
        with_critic="critic_params" in raw,
    )
    params = io.load_params(template, run_dir + "/params.msgpack")
    env_im, env_im_params = common.imitator_env(config)

    ep = policy_rollout(
        env_im, env_im_params, policy, params, normalizer,
        jax.random.PRNGKey(20260817),
        num_steps=config.get_path("mpc.evaluate.max_interactions", 1000),
        history=config.mpc.history, num_envs=n_ep,
    )
    qpos = np.asarray(ep.qpos)[..., 0]     # (n_ep, T)
    rews = np.asarray(ep.rewards)          # (n_ep, T)

    rows = []
    for i in range(n_ep):
        th = np.arctan2(np.sin(qpos[i]), np.cos(qpos[i]))
        up = np.abs(th) < 0.3
        down = np.abs(th) > 0.9
        cap, c = -1, 0
        for t, u in enumerate(up):
            c = c + 1 if u else 0
            if c >= 50:
                cap = t - 49
                break
        falls = 0
        if cap >= 0:
            in_up = True
            for t in range(cap, len(up)):
                if in_up and down[t]:
                    falls += 1
                    in_up = False
                elif not in_up and up[t]:
                    in_up = True
        rows.append((th[0], rews[i].sum(), cap, falls, up.sum()))

    rows.sort(key=lambda r: r[1])
    for th0, ret, cap, falls, ups in rows:
        print(f"start {th0:6.2f}: return {ret:7.1f} first_capture "
              f"{cap:5d} falls {falls} up_steps {ups}")

    rets = np.array([r[1] for r in rows])
    caps = np.array([r[2] for r in rows])
    falls = np.array([r[3] for r in rows])
    print(f"\nmean {rets.mean():.1f} min {rets.min():.1f} "
          f"episodes<500: {(rets < 500).sum()}/{n_ep}")
    slow = (caps > 300) | (caps < 0)
    print(f"slow-or-no capture (>300 steps): {int(slow.sum())}; "
          f"episodes with falls: {int((falls > 0).sum())}; "
          f"total falls {int(falls.sum())}")
    # reward lost to late capture vs falls (each fall ~ a recapture
    # cycle; each capture step earns ~0.95)
    late = np.clip(caps, 0, None)
    print(f"mean first-capture step: {late[caps >= 0].mean():.0f} "
          f"(capped at 1000 for never-captured)")


if __name__ == "__main__":
    main()
