"""Expert prediction model runner.

Capability parity with ``/root/reference/expert/runner.py``: load expert
trajectories, fit the normalizer, build sequence windows, train the
autoregressive predictor, evaluate it closed-loop in the (shifted) env,
and persist params + config under an auto-increment run directory.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import optax

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.data.windows import split_sequence_windows
from gan_mpc_tpu.envs.rollout import average_return
from gan_mpc_tpu.runners import common
from gan_mpc_tpu.training.expert import train_expert
from gan_mpc_tpu.utils import io


def expert_eval_policy(model):
    """Closed-loop policy from the predictor: teacher-forced replay of the
    observed history, act with the final predicted action
    (``/root/reference/expert/runner.py:95-103``)."""

    def policy_fn(params, history_x, history_u):
        del history_u
        carry = model.init_carry(history_x[0])
        _, (_, useq) = model.apply(params, carry, history_x, True)
        return useq[-1]

    return policy_fn


def run(config: Config, log_fn=print):
    from gan_mpc_tpu import runtime_setup

    runtime_setup.setup()
    key = jax.random.PRNGKey(config.seed)
    env = common.make_env(config.env.name)
    trajs = common.ensure_trajectories(config)
    normalizer = common.build_normalizer(config, trajs)

    tcfg = config.expert_prediction.train
    states = normalizer.normalize_state(jnp.asarray(trajs.states))
    actions = normalizer.normalize_action(jnp.asarray(trajs.actions))
    # rest-start oversampling: closed-loop rollouts begin at reset states
    # (zero velocity), which plain sliding windows cover at <1%. Split
    # happens BEFORE oversampling so duplicated early windows never leak
    # into the held-out split (see data/windows.py).
    key, k_split, k_train, k_eval = jax.random.split(key, 4)
    train_data, test_data = split_sequence_windows(
        states,
        actions,
        tcfg.seqlen,
        k_split,
        start_oversample=tcfg.get_path("start_oversample", 20),
    )

    model = common.build_expert_model(config, env.obs_size, env.act_size)
    params = model.init_params(key)
    tx = optax.chain(
        optax.clip_by_global_norm(100.0), optax.adam(tcfg.learning_rate)
    )
    opt_state = tx.init(params)

    params, opt_state, train_losses, test_loss = train_expert(
        model,
        params,
        tx,
        opt_state,
        train_data,
        test_data,
        num_epochs=tcfg.num_epochs,
        batch_size=tcfg.batch_size,
        key=k_train,
        discount_factor=tcfg.discount_factor,
        teacher_forcing_factor=tcfg.teacher_forcing_factor,
        log_fn=log_fn,
    )

    env_im, env_im_params = common.imitator_env(config)
    avg_reward = float(
        average_return(
            env_im,
            env_im_params,
            jax.jit(expert_eval_policy(model)),
            params,
            normalizer,
            k_eval,
            num_steps=config.get_path("mpc.evaluate.max_interactions", 1000),
            history=tcfg.seqlen - 1,
            num_runs=config.get_path("expert_prediction.eval_runs", 3),
        )
    )

    run_dir = io.new_run_dir(common.expert_model_dir(config))
    io.save_params(params, os.path.join(run_dir, "params.msgpack"))
    io.save_json(
        {
            "env": config.env.to_dict(),
            "model": config.expert_prediction.model.to_dict(),
            "train": tcfg.to_dict(),
            # Identity of the DATA this predictor was trained on: a
            # cached predictor must be invalidated when the underlying
            # expert data changes (expert version bump, physics or
            # collection-knob change) — otherwise downstream imitation
            # silently runs with goals from a stale expert under a
            # mismatched normalizer (measured round 5: the cheetah v2
            # retrain reused the v1-data predictor and trained to 2.4
            # vs the v1 pipeline's 30.5).
            "collection_fingerprint": common.collection_fingerprint(
                config
            ),
            "loss": {
                "train_loss": round(train_losses[-1], 5),
                "test_loss": round(test_loss, 5),
            },
            "avg_reward": round(avg_reward, 2),
        },
        os.path.join(run_dir, "config.json"),
    )
    if log_fn is not None:
        log_fn(f"[expert] avg_reward {avg_reward:.2f} saved to {run_dir}")
    return {
        "params": params,
        "run_dir": run_dir,
        "avg_reward": avg_reward,
        "train_loss": train_losses[-1],
        "test_loss": test_loss,
    }


def load_pretrained_expert(config: Config, x_size: int, u_size: int):
    """Load a saved expert by ``mpc.model.expert.load_id`` (or latest run)
    and RECONSTRUCT ITS MODEL FROM ITS OWN SAVED config.json — not from
    the current YAML — so an expert trained under a different architecture
    restores correctly (``/root/reference/utils.py:216-227`` +
    ``expert/expert_model.py:17-50``). Returns ``(model, params)``."""
    run_dir = io.latest_run_dir(
        common.expert_model_dir(config),
        config.get_path("mpc.model.expert.load_id"),
    )
    saved = io.load_json(os.path.join(run_dir, "config.json"))
    # Data-identity guard: a predictor trained on a different expert
    # data generation (scripted-expert version bump, physics change,
    # collection knobs) is stale — its goals come from the OLD expert
    # under the OLD normalizer stats. Only enforced when the saved run
    # recorded its fingerprint (new field; old runs predate it and an
    # explicit load_id is an intentional override).
    saved_fp = saved.get("collection_fingerprint")
    if (
        saved_fp is not None
        and config.get_path("mpc.model.expert.load_id") is None
        and saved_fp != common.collection_fingerprint(config)
    ):
        raise FileNotFoundError(
            f"expert predictor at {run_dir} was trained on data "
            f"fingerprint {saved_fp}, current is "
            f"{common.collection_fingerprint(config)}; retraining"
        )
    model = common.build_expert_model_from_dict(
        saved["model"], x_size, u_size
    )
    template = model.init_params(jax.random.PRNGKey(0))
    params = io.load_params(
        template, os.path.join(run_dir, "params.msgpack")
    )
    return model, params
