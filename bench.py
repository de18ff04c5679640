"""Throughput benchmark: batched env+planner steps/sec on one device.

The north-star metric from BASELINE.json: closed-loop MPC control — every
env step runs a full iLQR plan (expert goal generation, dynamics-carry
warmup, solver iterations over the horizon) followed by a physics step —
batched over many parallel environments, entirely on device.

Prints one JSON line per row: {"metric", "value", "unit", "vs_baseline",
"device", "compile_seconds", "mean_reward"}. ``vs_baseline`` is value /
10_000 (the BASELINE.json target steps/sec). The FIRST line is always
the flagship random-weights row (the pessimistic bound: random
cost/dynamics barely converge, so the convergence gate never exits
early). When the committed cheetah gan/4 run dir exists, a SECOND line
reports the TRAINED production checkpoint at its own solver budget — the
number a deployed policy actually runs at.

Defaults: cheetah_run (the BASELINE target's "cheetah-class" task), 512
parallel envs, iLQR capped at 5 warm-started iterations per control step
(standard real-time-iteration MPC practice; the solver is
convergence-gated at tol 1e-4 so most steps use fewer).
Override via BENCH_ENV / BENCH_NUM_ENVS / BENCH_ILQR_ITERS / BENCH_HORIZON.

BENCH_CHECKPOINT=<run_dir> benches ONLY that trained imitator: policy,
solver settings, env (with the run's physics shift), and normalizer are
all rebuilt from the run's own config.json.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

# The committed production checkpoint benched as the default second row.
DEFAULT_CHECKPOINT = "runs/trained_models/imitator/cheetah_run/gan/4"


def _load_checkpoint(checkpoint):
    from gan_mpc_tpu.runners import common
    from gan_mpc_tpu.utils import io, serialization

    config = common.load_run_config(checkpoint)
    env, env_params = common.imitator_env(config)
    env_name = config.env.name + " (trained ckpt)"
    horizon = config.mpc.horizon
    max_iters = config.mpc.get_path("solver.max_iterations", 30)
    trajs = common.ensure_trajectories(config)
    norm = common.build_normalizer(config, trajs)
    with open(checkpoint + "/params.msgpack", "rb") as fp:
        raw = serialization.msgpack_restore(fp.read())
    policy, template = common.build_policy(
        config, env.obs_size, env.act_size,
        with_critic="critic_params" in raw,
    )
    params = io.load_params(template, checkpoint + "/params.msgpack")
    return (env, env_params, env_name, horizon, max_iters, norm, policy,
            params, config.mpc.history)


def _flagship_setup(env_name, horizon, max_iters):
    import __graft_entry__ as ge
    from gan_mpc_tpu.data.normalizer import Normalizer
    from gan_mpc_tpu.envs import make_env

    env = make_env(env_name)
    env_params = env.default_params()
    policy, params, x_size, u_size = ge._flagship(
        horizon=horizon,
        max_iterations=max_iters,
        x_size=env.obs_size,
        u_size=env.act_size,
        riccati=os.environ.get("BENCH_RICCATI", "sequential"),
        inner_unroll=int(os.environ.get("BENCH_UNROLL", "1")),
        ls_materialize=os.environ.get("BENCH_LS", "auto"),
        compute_dtype=os.environ.get("BENCH_DTYPE", "float32"),
        num_alphas=int(os.environ.get("BENCH_ALPHAS", "16")),
    )
    norm = Normalizer.identity(x_size, u_size)
    return (env, env_params, env_name, horizon, max_iters, norm, policy,
            params, 1)


def bench_row(setup, num_envs, num_steps):
    """Measure one configuration; returns the JSON-able row dict."""
    from gan_mpc_tpu.envs.rollout import policy_rollout

    (env, env_params, env_name, horizon, max_iters, norm, policy, params,
     history) = setup

    # Batch-native planner path when the dynamics net supports it: the
    # whole env batch enters ONE solver instance (planner/batch_ilqr.py)
    # and the fused batch MLP ops see real batches in the hot loop.
    run = jax.jit(
        lambda params, key: policy_rollout(
            env,
            env_params,
            policy,
            params,
            norm,
            key,
            num_steps=num_steps,
            history=history,
            num_envs=num_envs,
        )
    )

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    run = run.lower(params, key).compile()
    compile_seconds = time.perf_counter() - t0
    ep = run(params, key)  # warmup
    mean_reward = float(jnp.mean(ep.rewards))
    if not jnp.all(jnp.isfinite(ep.rewards)):
        raise FloatingPointError(f"non-finite rewards in the {env_name} row")

    t0 = time.perf_counter()
    reps = 3
    for i in range(reps):
        ep = run(params, jax.random.fold_in(key, i))
        jax.block_until_ready(ep.rewards)
    dt = (time.perf_counter() - t0) / reps

    steps_per_sec = num_envs * num_steps / dt
    return {
        "metric": "batched env+planner steps/sec (one device, "
        f"{env_name}, {num_envs} envs, iLQR<= {max_iters} iters, "
        f"H={horizon})",
        "value": round(steps_per_sec, 1),
        "unit": "steps/sec",
        "vs_baseline": round(steps_per_sec / 10_000.0, 4),
        "device": jax.devices()[0].device_kind,
        "compile_seconds": round(compile_seconds, 2),
        "mean_reward": mean_reward,
    }


def main():
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 512))
    num_steps = int(os.environ.get("BENCH_NUM_STEPS", 50))
    horizon = int(os.environ.get("BENCH_HORIZON", 5))
    max_iters = int(os.environ.get("BENCH_ILQR_ITERS", 5))
    env_name = os.environ.get("BENCH_ENV", "cheetah_run")

    checkpoint = os.environ.get("BENCH_CHECKPOINT", "")
    if checkpoint:
        row = bench_row(_load_checkpoint(checkpoint), num_envs, num_steps)
        print(json.dumps(row))
        return

    row = bench_row(
        _flagship_setup(env_name, horizon, max_iters), num_envs, num_steps
    )
    print(json.dumps(row), flush=True)

    # Second line: the committed production checkpoint, when present.
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DEFAULT_CHECKPOINT)
    if os.path.exists(os.path.join(ckpt, "params.msgpack")):
        row2 = bench_row(_load_checkpoint(ckpt), num_envs, num_steps)
        print(json.dumps(row2))


if __name__ == "__main__":
    sys.exit(main())
