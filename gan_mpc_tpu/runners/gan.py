"""GAN-MPC training runner (the reference's ``gan`` app).

Capability parity with ``/root/reference/gan/runner.py``: per epoch,
alternate dynamics (on-policy) -> critic (discriminator on planned vs
expert futures) -> cost/generator (bilevel planner gradient against the
critic), then evaluate and persist.
"""

from __future__ import annotations

import contextlib

import os

import jax

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.policies.losses import gan_generator_loss
from gan_mpc_tpu.runners import common, l2 as l2_runner
from gan_mpc_tpu.training.cost import train_cost
from gan_mpc_tpu.training.critic import train_critic
from gan_mpc_tpu.training.dynamics import train_dynamics
from gan_mpc_tpu.training.masking import masked_adam
from gan_mpc_tpu.utils import io
from gan_mpc_tpu.utils.metrics import MetricsRecorder, profiler_trace


def _run_fused_epochs(
    config, ctx, params, opts, opt_states, replay, key, history, metrics,
    log_fn, ckpt=None, start_epoch=1,
):
    """Alternate epoch loop: each epoch is ONE jitted XLA program
    (training/fused_epoch.py). Enabled via runtime.fused_epochs: true.
    Emits the same train AND held-out test metrics as the modular loop,
    runs the periodic eval / best-checkpoint selection, and checkpoints
    with the same state keys. Returns (params, replay, key, best_eval,
    best_params)."""
    import jax.numpy as jnp

    from gan_mpc_tpu.training.fused_epoch import make_fused_gan_epoch

    tcfg = config.mpc.train
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic
    cost_train, cost_test = ctx["cost_data"]
    n_envs = config.get_path("runtime.num_parallel_envs", 1)
    # runtime.data_parallel_devices > 1 runs every epoch dp-sharded over
    # a device mesh (training/fused_epoch.py mesh mode) — the multi-chip
    # path for the shipping configuration
    mesh = common.maybe_mesh(config)
    epoch_fn = make_fused_gan_epoch(
        ctx["policy"],
        ctx["env_im"],
        ctx["env_im_params"],
        ctx["normalizer"],
        opts,
        cost_train[0],
        cost_train[1],
        num_envs=n_envs,
        episode_steps=dcfg.max_interactions_per_episode,
        history=config.mpc.history,
        dynamics_updates=dcfg.num_updates,
        critic_updates=qcfg.num_updates,
        cost_updates=ccfg.num_updates,
        batch_size=ccfg.batch_size,
        gamma=dcfg.discount_factor,
        polyak_factor=ccfg.polyak_factor,
        critic_plan_batch=min(
            qcfg.get_path("plan_batch", 64), cost_train[0].shape[0]
        ),
        expert_history_X_test=cost_test[0],
        expert_future_Y_test=cost_test[1],
        expert_dyn_windows=ctx["dyn_train"],
        expert_dyn_updates=dcfg.get_path("expert_updates", 0),
        chunk_updates=config.get_path("runtime.fused_chunk_updates", 0),
        plan_chunk=config.get_path("runtime.fused_plan_chunk", 0),
        collect_noise=dcfg.get_path("collection_noise", 0.0),
        collect_chunk_steps=config.get_path(
            "runtime.fused_collect_chunk", 0
        ),
        mesh=mesh,
    )
    # epoch-1 dynamics warm start on the expert windows, as in the
    # modular path (training/dynamics.py:136-150)
    warm = dcfg.get_path("warm_start_updates", 3)
    if start_epoch == 1 and warm > 0:
        from gan_mpc_tpu.training.dynamics import _run_updates

        key, sub = jax.random.split(key)
        params, opt_states["dynamics"], _ = _run_updates(
            ctx["policy"].dynamics_model,
            opts["dynamics"],
            params,
            opt_states["dynamics"],
            ctx["dyn_train"],
            num_updates=warm,
            batch_size=dcfg.batch_size,
            gamma=dcfg.discount_factor,
            teacher_forcing_factor=1.0,
            key=sub,
        )
    best_eval, best_params = float("-inf"), None
    every = config.get_path("mpc.evaluate.every_epochs", 0)
    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        key, sub = jax.random.split(key)
        tf = jnp.asarray(
            epoch <= tcfg.num_epochs * dcfg.teacher_forcing_factor
        )
        params, opt_states, replay, m = epoch_fn(
            params, opt_states, replay, sub, tf
        )
        history["episode_returns"].append(float(m.episode_return))
        history["dynamics_train_losses"].append(float(m.dynamics_loss))
        history["critic_train_losses"].append(float(m.critic_loss))
        history["critic_test_losses"].append(float(m.critic_test_loss))
        history["cost_train_losses"].append(float(m.generator_loss))
        history["cost_test_losses"].append(float(m.generator_test_loss))
        metrics.record(
            epoch,
            episode_return=float(m.episode_return),
            dynamics_train_loss=float(m.dynamics_loss),
            critic_train_loss=float(m.critic_loss),
            critic_test_loss=float(m.critic_test_loss),
            generator_train_loss=float(m.generator_loss),
            generator_test_loss=float(m.generator_test_loss),
        )
        if ckpt is not None:
            ckpt.maybe_save(
                epoch,
                {
                    "params": params,
                    "cost_opt_state": opt_states["cost"],
                    "dyn_opt_state": opt_states["dynamics"],
                    "critic_opt_state": opt_states["critic"],
                    "replay": replay,
                    "key": key,
                },
            )
        if log_fn is not None:
            log_fn(
                f"[gan/fused] epoch {epoch} return {float(m.episode_return):.1f} "
                f"dyn {float(m.dynamics_loss):.5f} "
                f"critic {float(m.critic_loss):.5f} "
                f"gen {float(m.generator_loss):.5f}"
            )
        if every and epoch % every == 0:
            key, k_mid = jax.random.split(key)
            ctx["params"] = params
            mid = l2_runner.evaluate(
                config, ctx, k_mid,
                num_runs=config.get_path("mpc.evaluate.midrun_episodes", 3),
            )
            metrics.record(epoch, eval_reward=mid)
            common.record_solver_stats(
                metrics, ctx["policy"], params, cost_test, epoch
            )
            if mid >= best_eval:
                best_eval, best_params = mid, params
            l2_runner.note_candidate(ctx, mid, params, config=config)
            if log_fn is not None:
                log_fn(f"[gan/fused] epoch {epoch} eval_reward {mid:.1f}"
                       f" (best {best_eval:.1f})")
    return params, opt_states, replay, key, best_eval, best_params


def _dagger_rounds(
    config, ctx, params, opts, opt_states, replay, key, history, metrics,
    log_fn, best_eval, best_params,
):
    """DAgger expert-predictor refinement (framework extension; no
    reference counterpart — its predictor only ever sees the external
    expert's visitation). Per round: collect corrective scripted-expert
    segments from states the CURRENT best policy visits
    (collect.collect_dagger_trajectories), fine-tune the expert predictor
    on base + corrective windows, then continue adversarial training for
    ``extra_epochs`` with the refreshed goal generator. Returns the
    updated (params, replay, key, best_eval, best_params)."""
    dag = config.get_path("expert_prediction.dagger")
    if dag is None or dag.get_path("rounds", 0) <= 0:
        return params, replay, key, best_eval, best_params
    import jax.numpy as jnp
    import optax

    from gan_mpc_tpu.data.windows import split_sequence_windows
    from gan_mpc_tpu.runners.collect import collect_dagger_trajectories
    from gan_mpc_tpu.training.expert import train_expert

    tcfg = config.expert_prediction.train
    norm = ctx["normalizer"]
    trajs = ctx["trajs"]
    base_states = jnp.asarray(norm.normalize_state(jnp.asarray(trajs.states)))
    base_actions = jnp.asarray(
        norm.normalize_action(jnp.asarray(trajs.actions))
    )
    expert_model = ctx["policy"].expert_model
    for rnd in range(1, dag.get_path("rounds", 0) + 1):
        key, k_col, k_win, k_ft = jax.random.split(key, 4)
        if best_params is not None:
            params = best_params
        dtrajs = collect_dagger_trajectories(
            ctx["env"],
            ctx["env"].default_params(),
            ctx["policy"],
            params,
            norm,
            k_col,
            num_segments=dag.get_path("num_segments", 256),
            segment_steps=dag.get_path("segment_steps", 120),
            policy_steps=config.get_path(
                "mpc.evaluate.max_interactions", 1000
            ),
            policy_episodes=dag.get_path("policy_episodes", 8),
            noise_sigma=config.get_path("env.expert_noise", 0.25),
            history=config.mpc.history,
            imitator_env=ctx["env_im"],
            imitator_env_params=ctx["env_im_params"],
            state_weighting=dag.get_path("state_weighting", "uniform"),
            weight_power=dag.get_path("weight_power", 2.0),
            weight_floor=dag.get_path("weight_floor", 0.05),
        )
        d_states = jnp.asarray(
            norm.normalize_state(jnp.asarray(dtrajs.states))
        )
        d_actions = jnp.asarray(
            norm.normalize_action(jnp.asarray(dtrajs.actions))
        )
        seqlen = tcfg.seqlen
        bt, bv = split_sequence_windows(
            base_states, base_actions, seqlen, k_win,
            start_oversample=tcfg.get_path("start_oversample", 20),
        )
        dt, dv = split_sequence_windows(
            d_states, d_actions, seqlen, jax.random.fold_in(k_win, 1)
        )
        train_data = tuple(
            jnp.concatenate([a, b]) for a, b in zip(bt, dt)
        )
        test_data = tuple(jnp.concatenate([a, b]) for a, b in zip(bv, dv))
        tx = optax.chain(
            optax.clip_by_global_norm(100.0),
            optax.adam(dag.get_path("finetune_lr", 5e-5)),
        )
        eparams, _, _, ft_test = train_expert(
            expert_model,
            params["expert_params"],
            tx,
            tx.init(params["expert_params"]),
            train_data,
            test_data,
            num_epochs=dag.get_path("finetune_epochs", 6),
            batch_size=tcfg.batch_size,
            key=k_ft,
            discount_factor=tcfg.discount_factor,
            teacher_forcing_factor=1.0,
            log_fn=None,
        )
        params = dict(params, expert_params=eparams)
        metrics.record(rnd, dagger_round=rnd, dagger_test_loss=float(ft_test))
        if log_fn is not None:
            log_fn(
                f"[gan/dagger] round {rnd}: "
                f"{dtrajs.states.shape[0]} corrective segments, "
                f"predictor test loss {float(ft_test):.5f}"
            )
        extra = dag.get_path("extra_epochs", 10)
        if extra > 0:
            d = config.to_dict()
            d["mpc"]["train"]["num_epochs"] = extra
            d["mpc"]["train"]["dynamics"]["warm_start_updates"] = 0
            cfg2 = Config.from_dict(d)
            # continuation epochs are real training: record them in the
            # run's loss history (a resumed-at-final-epoch run otherwise
            # finishes with EMPTY curves and the artifact save fails)
            params, opt_states, replay, key, be, bp = _run_fused_epochs(
                cfg2, ctx, params, opts, opt_states, replay, key,
                history, metrics, log_fn, ckpt=None, start_epoch=1,
            )
            if be >= best_eval:
                best_eval, best_params = be, bp
        else:
            # no continuation: let the refreshed predictor stand on its own
            key, k_mid = jax.random.split(key)
            ctx["params"] = params
            mid = l2_runner.evaluate(
                config, ctx, k_mid,
                num_runs=config.get_path("mpc.evaluate.midrun_episodes", 3),
            )
            if mid >= best_eval:
                best_eval, best_params = mid, params
            l2_runner.note_candidate(ctx, mid, params, config=config)
    return params, replay, key, best_eval, best_params


def run(config: Config, log_fn=print):
    from gan_mpc_tpu import runtime_setup

    runtime_setup.setup()
    ctx = l2_runner.setup(config, with_critic=True)
    policy, params = ctx["policy"], ctx["params"]
    tcfg = config.mpc.train
    ccfg, dcfg, qcfg = tcfg.cost, tcfg.dynamics, tcfg.critic

    cost_opt, cost_opt_state = masked_adam(
        params,
        ccfg.no_grads,
        ccfg.learning_rate,
        weights_learning_rate=ccfg.get_path("weights_learning_rate"),
    )
    dyn_opt, dyn_opt_state = masked_adam(
        params, dcfg.no_grads, dcfg.learning_rate
    )
    critic_opt, critic_opt_state = masked_adam(
        params, qcfg.no_grads, qcfg.learning_rate
    )

    key = ctx["key"]
    replay = ctx["replay"]
    cost_train, cost_test = ctx["cost_data"]
    metrics = MetricsRecorder(
        os.path.join(
            config.get_path("runtime.workdir", "runs"),
            "metrics",
            config.env.name,
            "gan.jsonl",
        )
    )
    ckpt = l2_runner.checkpointer_for(config, "gan")
    best_eval, best_params = float("-inf"), None
    start_epoch = 1
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(
            {
                "params": params,
                "cost_opt_state": cost_opt_state,
                "dyn_opt_state": dyn_opt_state,
                "critic_opt_state": critic_opt_state,
                "replay": replay,
                "key": key,
            }
        )
        params = state["params"]
        cost_opt_state = state["cost_opt_state"]
        dyn_opt_state = state["dyn_opt_state"]
        critic_opt_state = state["critic_opt_state"]
        replay = state["replay"]
        key = state["key"]
        start_epoch = ckpt.latest_step() + 1
        if log_fn is not None:
            log_fn(f"[gan] resumed from checkpoint at epoch {start_epoch - 1}")
    history = {
        "dynamics_train_losses": [],
        "critic_train_losses": [],
        "critic_test_losses": [],
        "cost_train_losses": [],
        "cost_test_losses": [],
        "episode_returns": [],
    }
    if config.get_path("runtime.fused_epochs", False):
        opts = {"dynamics": dyn_opt, "critic": critic_opt, "cost": cost_opt}
        opt_states_d = {
            "dynamics": dyn_opt_state,
            "critic": critic_opt_state,
            "cost": cost_opt_state,
        }
        params, opt_states_d, replay, key, best_eval, best_params = (
            _run_fused_epochs(
                config, ctx, params, opts, opt_states_d, replay, key,
                history, metrics, log_fn, ckpt=ckpt, start_epoch=start_epoch,
            )
        )
        params, replay, key, best_eval, best_params = _dagger_rounds(
            config, ctx, params, opts, opt_states_d, replay, key,
            history, metrics, log_fn, best_eval, best_params,
        )
        start_epoch = tcfg.num_epochs + 1  # skip the modular loop
    profile_dir = config.get_path("runtime.profile_dir")
    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        key, k_dyn, k_critic, k_cost = jax.random.split(key, 4)
        # jax.profiler trace of the first trained epoch when enabled
        stack = contextlib.ExitStack()
        stack.enter_context(
            profiler_trace(profile_dir if epoch == start_epoch else None)
        )
        stack.enter_context(metrics.timed("epoch", epoch))
        params, dyn_opt_state, replay, ep_returns, dyn_losses = train_dynamics(
            policy.dynamics_model,
            dyn_opt,
            params,
            dyn_opt_state,
            ctx["dyn_train"],
            replay,
            ctx["collect_fn"],
            ctx["normalizer"],
            num_episodes=dcfg.num_episodes,
            num_updates=dcfg.num_updates,
            batch_size=dcfg.batch_size,
            discount_factor=dcfg.discount_factor,
            teacher_forcing_factor=dcfg.teacher_forcing_factor,
            key=k_dyn,
            epoch=epoch,
            warm_start_updates=dcfg.get_path("warm_start_updates", 3),
            expert_updates=dcfg.get_path("expert_updates", 0),
        )
        params, critic_opt_state, critic_losses, critic_tests = train_critic(
            policy,
            critic_opt,
            params,
            critic_opt_state,
            cost_train,
            cost_test,
            num_updates=qcfg.num_updates,
            batch_size=qcfg.batch_size,
            key=k_critic,
            plan_batch=qcfg.get_path("plan_batch", 256),
        )
        params, cost_opt_state, gen_losses, gen_tests = train_cost(
            policy,
            cost_opt,
            params,
            cost_opt_state,
            cost_train,
            cost_test,
            gan_generator_loss,
            num_updates=ccfg.num_updates,
            batch_size=ccfg.batch_size,
            polyak_factor=ccfg.polyak_factor,
            key=k_cost,
            has_targets=True,  # targets ignored by the GAN loss but keep
            # the same minibatch stream as the reference
            eval_windows=ccfg.get_path("eval_windows", None),
            max_steps_per_update=ccfg.get_path("steps_per_update", None),
        )
        stack.close()
        history["dynamics_train_losses"] += dyn_losses
        history["critic_train_losses"] += critic_losses
        history["critic_test_losses"] += critic_tests
        history["cost_train_losses"] += gen_losses
        history["cost_test_losses"] += gen_tests
        history["episode_returns"] += ep_returns
        metrics.record(
            epoch,
            episode_return=ep_returns[-1],
            dynamics_train_loss=dyn_losses[-1],
            critic_train_loss=critic_losses[-1],
            generator_train_loss=gen_losses[-1],
        )
        if ckpt is not None:
            ckpt.maybe_save(
                epoch,
                {
                    "params": params,
                    "cost_opt_state": cost_opt_state,
                    "dyn_opt_state": dyn_opt_state,
                    "critic_opt_state": critic_opt_state,
                    "replay": replay,
                    "key": key,
                },
            )
        if log_fn is not None:
            log_fn(
                f"[gan] epoch {epoch} return {ep_returns[-1]:.1f} "
                f"dyn {dyn_losses[-1]:.5f} critic {critic_losses[-1]:.5f} "
                f"gen {gen_losses[-1]:.5f}"
            )
        every = config.get_path("mpc.evaluate.every_epochs", 0)
        if every and epoch % every == 0:
            key, k_mid = jax.random.split(key)
            ctx["params"] = params
            mid = l2_runner.evaluate(
                config, ctx, k_mid,
                num_runs=config.get_path("mpc.evaluate.midrun_episodes", 3),
            )
            metrics.record(epoch, eval_reward=mid)
            common.record_solver_stats(
                metrics, policy, params, cost_test, epoch
            )
            if mid >= best_eval:
                best_eval, best_params = mid, params
            l2_runner.note_candidate(ctx, mid, params, config=config)
            if log_fn is not None:
                log_fn(f"[gan] epoch {epoch} eval_reward {mid:.1f}"
                       f" (best {best_eval:.1f})")

    # Honest model selection: re-rank the top midrun checkpoints with the
    # full evaluation budget (adversarial training is non-monotonic and
    # midrun evals are noisy; see l2.select_best_params).
    key, k_sel = jax.random.split(key)
    params = l2_runner.select_best_params(config, ctx, params, k_sel, log_fn)
    ctx["params"] = params
    key, k_cal = jax.random.split(key)
    params = l2_runner.calibrate_gain(config, ctx, k_cal, log_fn)
    key, k_eval = jax.random.split(key)
    avg_reward = l2_runner.evaluate(config, ctx, k_eval)
    fresh_result = l2_runner.fresh_seed_eval(config, ctx, log_fn)
    dm_result = l2_runner.dm_cross_eval(config, ctx, log_fn)

    run_dir = io.new_run_dir(common.imitator_model_dir(config, "gan"))
    io.save_params(params, os.path.join(run_dir, "params.msgpack"))

    def _last(name):  # curves can be empty (e.g. a 0-epoch resumed run)
        values = history[name]
        return round(values[-1], 5) if values else None

    io.save_json(
        {
            "seed": config.seed,
            "env": config.env.to_dict(),
            "reward": round(avg_reward, 2),
            "fresh_eval": fresh_result,
            "dm_control_reward": dm_result,
            "loss": {
                "dynamics": {"train_loss": _last("dynamics_train_losses")},
                "critic": {
                    "train_loss": _last("critic_train_losses"),
                    "test_loss": _last("critic_test_losses"),
                },
                "cost": {
                    "train_loss": _last("cost_train_losses"),
                    "test_loss": _last("cost_test_losses"),
                },
            },
            "policy": config.mpc.to_dict(),
            # rebuildable provenance (see l2.py save site / ADVICE r3)
            "expert_prediction": config.expert_prediction.to_dict(),
        },
        os.path.join(run_dir, "config.json"),
    )
    for name, values in history.items():
        io.save_json(values, os.path.join(run_dir, f"{name}.json"))
    key, k_video = jax.random.split(key)
    l2_runner.maybe_save_video(config, ctx, run_dir, k_video)
    metrics.close()
    if ckpt is not None:
        # run completed: clear the crash-resume state so the next fresh
        # invocation trains from scratch instead of resuming a finished
        # run's final checkpoint
        ckpt.clear()
        ckpt.close()
    if log_fn is not None:
        log_fn(f"[gan] avg_reward {avg_reward:.2f} saved to {run_dir}")
    return {
        "params": params,
        "run_dir": run_dir,
        "avg_reward": avg_reward,
        "history": history,
    }


if __name__ == "__main__":
    import sys

    path = sys.argv[1] if len(sys.argv) > 1 else "configs/gan_pendulum.yaml"
    run(Config.from_yaml(path))
