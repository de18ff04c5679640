"""One GAN-MPC training epoch as a SINGLE jitted XLA program.

The north-star design goal (SURVEY.md §7, BASELINE.json): the entire
plan-act-learn loop on device with no host round trips. The modular
trainers (``training/*.py``) already jit each scanned segment; this module
goes the rest of the way — one ``jax.jit`` whose body is:

    1. on-policy collection: N parallel envs x (iLQR plan -> physics step)
       inside a ``lax.scan``;
    2. window the episodes and push them into the device ring replay;
    3. scanned dynamics updates from replay samples;
    4. critic dataset built by batched planning on expert histories,
       scanned BCE updates;
    5. scanned bilevel cost/generator updates through the planner's
       implicit VJP, with the Polyak blend.

Expert windows are closed over as device constants. The only host work
per epoch is reading back the scalar losses.

Chunked mode (``chunk_updates``) bounds how long one XLA program runs (a
runtime that killed long-running programs at humanoid scale, H=50
fan-outs, was the reason; none is known on the GPU). Passing
``chunk_updates=N`` splits the
epoch at phase boundaries AND slices every scanned-update phase into
segments of at most N updates, each its own jitted program, with the
epoch state threaded through on device (no host transfers beyond the
program boundary itself). Segment programs are shape-stable, so each
compiles once; numerics are IDENTICAL to the single-program epoch —
the same update sequence, merely partitioned.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from gan_mpc_tpu.data.buffers import ReplayBuffer
from gan_mpc_tpu.data.windows import minibatch_indices
from gan_mpc_tpu.envs.rollout import policy_rollout
from gan_mpc_tpu.policies.losses import critic_bce_loss, gan_generator_loss
from gan_mpc_tpu.training.dynamics import multistep_prediction_loss
from gan_mpc_tpu.training.masking import polyak_blend


class FusedEpochMetrics(NamedTuple):
    episode_return: jax.Array
    dynamics_loss: jax.Array
    critic_loss: jax.Array
    generator_loss: jax.Array
    critic_test_loss: jax.Array
    generator_test_loss: jax.Array


class FusedL2Metrics(NamedTuple):
    episode_return: jax.Array
    dynamics_loss: jax.Array
    cost_loss: jax.Array
    cost_test_loss: jax.Array


def _chunks(n: int, c: int):
    """[(start, end)] slices of at most c; at most two distinct sizes so
    segment programs stay shape-stable (one extra compile for the tail)."""
    return [(s, min(s + c, n)) for s in range(0, max(n, 0), c)]


def _wmean(pairs):
    """Exact global mean from per-chunk (mean, count) pairs."""
    tot = sum(w for _, w in pairs)
    return sum(l * w for l, w in pairs) / max(tot, 1)


def make_fused_gan_epoch(
    policy,
    env,
    env_params,
    normalizer,
    optimizers: dict,  # {"dynamics": tx, "critic": tx, "cost": tx}
    expert_history_X,  # (N, history+1, x) normalized expert histories
    expert_future_Y,  # (N, horizon+1, x) normalized expert futures
    *,
    num_envs: int,
    episode_steps: int,
    history: int,
    dynamics_updates: int,
    critic_updates: int,
    cost_updates: int,
    batch_size: int,
    gamma: float,
    polyak_factor: float,
    critic_plan_batch: int = 64,
    expert_history_X_test=None,  # held-out split for test metrics
    expert_future_Y_test=None,
    test_plan_batch: int = 64,
    expert_dyn_windows=None,  # (X, U, Y) expert sequence windows
    expert_dyn_updates: int = 0,
    chunk_updates: int = 0,
    plan_chunk: int = 0,
    collect_noise: float = 0.0,
    collect_chunk_steps: int = 0,
    mesh=None,
    dp_axis: str = "dp",
):
    """Build the fused epoch. Returns
    ``epoch(params, opt_states, replay, key, teacher_forcing) ->
    (params, opt_states, replay, FusedEpochMetrics)``.

    ``mesh``: run the SAME single-program epoch data-parallel over the
    mesh's ``dp_axis`` (shard_map): collection envs, planning fan-outs,
    and every minibatch shard across devices; params / optimizer state /
    replay stay replicated and gradients ``pmean`` over the axis. Episode keys are split globally and row-sliced
    per device, and each per-update loss is the pmean of equal-size
    shard means — so the sharded epoch computes the single-device epoch
    to fp reduction order (tests/test_parallel.py). Mesh mode composes
    with the single-program epoch only (``chunk_updates`` must be 0; the
    chunking exists for one overloaded device, the mesh for many).

    When the test split is given, each epoch also emits held-out critic /
    generator losses (planning once on ``test_plan_batch`` test windows),
    matching the modular trainers' metrics. ``expert_dyn_windows`` +
    ``expert_dyn_updates`` reproduce the modular trainer's per-epoch
    expert-distribution refresh (``training/dynamics.py:151-169``) —
    pure on-policy data collapses the model onto wherever the policy
    visits.

    ``chunk_updates > 0`` selects the CHUNKED epoch (see
    module docstring): identical numerics, but every scanned-update phase
    is partitioned into programs of at most that many updates, and
    batched planning fan-outs into sub-batches of ``plan_chunk`` (0 =
    whole batch).
    """

    exp_X = jnp.asarray(expert_history_X)
    exp_Y = jnp.asarray(expert_future_Y)
    have_test = expert_history_X_test is not None
    if have_test:
        tX = jnp.asarray(expert_history_X_test)[:test_plan_batch]
        tY = jnp.asarray(expert_future_Y_test)[:test_plan_batch]
    have_exp_dyn = expert_dyn_windows is not None and expert_dyn_updates > 0
    if have_exp_dyn:
        edX, edU, edY = (jnp.asarray(a) for a in expert_dyn_windows)
    steps_per_update = max(exp_X.shape[0] // batch_size, 1)

    if mesh is not None:
        if chunk_updates:
            raise ValueError(
                "fused epoch: mesh mode and chunk_updates are exclusive"
            )
        num_dev = int(mesh.shape[dp_axis])
        for name, v in (
            ("num_envs", num_envs),
            ("batch_size", batch_size),
            ("critic_plan_batch", critic_plan_batch),
        ):
            if v % num_dev:
                raise ValueError(
                    f"fused epoch mesh mode: {name}={v} must divide the "
                    f"{dp_axis} axis size {num_dev}"
                )
        if have_test and tX.shape[0] % num_dev:
            raise ValueError(
                f"fused epoch mesh mode: test_plan_batch={tX.shape[0]} "
                f"must divide the {dp_axis} axis size {num_dev}"
            )
    else:
        num_dev = 1

    def _pmean(x):
        return jax.lax.pmean(x, dp_axis) if mesh is not None else x

    def _gather(x):
        # reassemble the global batch from per-device shards
        if mesh is None:
            return x
        return jax.lax.all_gather(x, dp_axis, axis=0, tiled=True)

    def _rows(x):
        # this device's equal-size slice of a replicated leading axis
        if mesh is None:
            return x
        n = x.shape[0] // num_dev
        return jax.lax.dynamic_slice_in_dim(
            x, jax.lax.axis_index(dp_axis) * n, n
        )

    def _scan_updates(params, opt, opt_state, loss_of_batch, perm):
        def body(carry, p):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_of_batch)(params, _rows(p))
            loss, grads = _pmean(loss), _pmean(grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), perm
        )
        return params, opt_state, jnp.mean(losses)

    def _plan_states(params, history_x):
        zeros_u = jnp.zeros(
            (history_x.shape[0] - 1, policy.expert_model.u_size),
            jnp.float32,
        )
        sol = policy.plan(params, history_x, zeros_u, warm_start_carry=False)
        return policy.planned_states(sol)

    # ---- phase bodies, shared by the single-program and chunked modes ----

    def _collect(params, replay, key):
        # on-policy collection (batched, fully on device; batch-native
        # planner when the dynamics net supports it) + replay insert.
        # Keys split GLOBALLY, rows per device: episode content is
        # invariant to the mesh size; the gathered batch keeps the
        # replicated replay identical on every device.
        env_keys = _rows(jax.random.split(key, num_envs))
        episode = policy_rollout(
            env,
            env_params,
            policy,
            params,
            normalizer,
            key,
            num_steps=episode_steps,
            history=history,
            num_envs=num_envs // num_dev,
            action_noise=collect_noise,
            env_keys=env_keys,
        )
        ep_return = _pmean(jnp.mean(jnp.sum(episode.rewards, axis=-1)))
        replay = replay.add_trajectories(
            _gather(normalizer.normalize_state(episode.states)),
            _gather(normalizer.normalize_action(episode.actions)),
        )
        return replay, ep_return

    def _dyn_loss_of(replay, teacher_forcing):
        def dyn_batch_loss(params, idx):
            X, U, Y = (
                replay.states[idx],
                replay.actions[idx],
                replay.next_states[idx],
            )
            losses = jax.vmap(
                lambda x, u, y: multistep_prediction_loss(
                    policy.dynamics_model,
                    params["dynamics_params"],
                    x,
                    u,
                    y,
                    gamma,
                    teacher_forcing,
                )
            )(X, U, Y)
            return jnp.mean(losses)

        return dyn_batch_loss

    def _exp_dyn_loss(params, idx):
        losses = jax.vmap(
            lambda x, u, y: multistep_prediction_loss(
                policy.dynamics_model,
                params["dynamics_params"],
                x,
                u,
                y,
                gamma,
                jnp.asarray(True),
            )
        )(edX[idx], edU[idx], edY[idx])
        return jnp.mean(losses)

    def _make_fakes(params, hX):
        # the planning fan-out shards over the mesh: each device plans
        # its rows, the gather rebuilds the global fake batch
        return _gather(
            jax.vmap(lambda hx: _plan_states(params, hx))(_rows(hX))
        )

    def _critic_loss_of(seqs, labels):
        def critic_batch_loss(params, idx):
            losses = jax.vmap(
                lambda s, l: critic_bce_loss(
                    policy.critic_model, params["critic_params"], s, l
                )
            )(seqs[idx], labels[idx])
            return jnp.mean(losses)

        return critic_batch_loss

    def _gen_scan(params, cost_state, perm):
        # scanned bilevel generator updates through the planner's
        # implicit VJP
        def gen_update(carry, idx):
            params, opt_state = carry
            loss, grads = policy.batched_loss_and_grad(
                params, exp_X[_rows(idx)], gan_generator_loss, ()
            )
            loss, grads = _pmean(loss), _pmean(grads)
            updates, opt_state = optimizers["cost"].update(
                grads, opt_state, params
            )
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, cost_state), gen_losses = jax.lax.scan(
            gen_update, (params, cost_state), perm
        )
        return params, cost_state, jnp.mean(gen_losses)

    def _test_metrics(params, fake_test):
        # held-out critic + generator losses from one planning pass
        seqs_t = jnp.concatenate([tY, fake_test], axis=0)
        labels_t = jnp.concatenate(
            [
                jnp.ones((tX.shape[0],), jnp.float32),
                -jnp.ones((tX.shape[0],), jnp.float32),
            ]
        )
        crit_test = jnp.mean(
            jax.vmap(
                lambda s, l: critic_bce_loss(
                    policy.critic_model, params["critic_params"], s, l
                )
            )(seqs_t, labels_t)
        )
        score_t = jax.vmap(
            lambda s: policy.critic_model.apply(params["critic_params"], s)
        )(fake_test)
        p_t = jax.nn.sigmoid(score_t)
        gen_test = jnp.mean(
            -jnp.log(p_t + 1e-6) + jnp.log(1.0 - p_t + 1e-6)
        )
        return crit_test, gen_test

    def _epoch_body(
        params, opt_states, replay: ReplayBuffer, key, teacher_forcing
    ):
        # independent streams per consumer (a shared key would correlate
        # the critic's plan-subset choice with its minibatch permutation)
        (
            k_collect,
            k_dyn,
            k_crit_idx,
            k_crit_perm,
            k_cost,
            k_shuffle,
        ) = jax.random.split(key, 6)

        replay, ep_return = _collect(params, replay, k_collect)

        # dynamics updates from replay
        dyn_perm = jax.random.randint(
            k_dyn,
            (dynamics_updates * steps_per_update, batch_size),
            0,
            jnp.maximum(replay.size, 1),
        )
        params, dyn_state, dyn_loss = _scan_updates(
            params,
            optimizers["dynamics"],
            opt_states["dynamics"],
            _dyn_loss_of(replay, teacher_forcing),
            dyn_perm,
        )

        # expert-distribution refresh (teacher-forced)
        if have_exp_dyn:
            exp_perm = jax.random.randint(
                jax.random.fold_in(k_dyn, 1),
                (expert_dyn_updates, batch_size),
                0,
                edX.shape[0],
            )
            params, dyn_state, _ = _scan_updates(
                params,
                optimizers["dynamics"],
                dyn_state,
                _exp_dyn_loss,
                exp_perm,
            )

        # critic: plan on a subset of expert histories
        plan_idx = jax.random.choice(
            k_crit_idx,
            exp_X.shape[0],
            shape=(critic_plan_batch,),
            replace=False,
        )
        fake_Y = _make_fakes(params, exp_X[plan_idx])
        seqs = jnp.concatenate([exp_Y[plan_idx], fake_Y], axis=0)
        labels = jnp.concatenate(
            [
                jnp.ones((critic_plan_batch,), jnp.float32),
                -jnp.ones((critic_plan_batch,), jnp.float32),
            ]
        )
        shuffle = jax.random.permutation(k_shuffle, 2 * critic_plan_batch)
        seqs, labels = seqs[shuffle], labels[shuffle]

        crit_perm = jax.random.randint(
            k_crit_perm,
            (critic_updates, batch_size),
            0,
            2 * critic_plan_batch,
        )
        params, crit_state, crit_loss = _scan_updates(
            params,
            optimizers["critic"],
            opt_states["critic"],
            _critic_loss_of(seqs, labels),
            crit_perm,
        )

        # bilevel generator updates + Polyak blend
        prev_params = params
        cost_perm = minibatch_indices(
            k_cost, exp_X.shape[0], cost_updates, batch_size
        )
        params, cost_state, gen_loss = _gen_scan(
            params, opt_states["cost"], cost_perm
        )
        params = polyak_blend(prev_params, params, polyak_factor)

        if have_test:
            fake_test = _make_fakes(params, tX)
            crit_test, gen_test = _test_metrics(params, fake_test)
        else:
            crit_test = jnp.float32(0.0)
            gen_test = jnp.float32(0.0)

        opt_states = {
            "dynamics": dyn_state,
            "critic": crit_state,
            "cost": cost_state,
        }
        metrics = FusedEpochMetrics(
            episode_return=ep_return,
            dynamics_loss=dyn_loss,
            critic_loss=crit_loss,
            generator_loss=gen_loss,
            critic_test_loss=crit_test,
            generator_test_loss=gen_test,
        )
        return params, opt_states, replay, metrics

    if mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        # everything in/out replicated: the data parallelism lives inside
        # (per-device key rows / minibatch slices + pmean/all_gather)
        epoch = jax.jit(
            shard_map(
                _epoch_body,
                mesh=mesh,
                in_specs=(P(), P(), P(), P(), P()),
                out_specs=(P(), P(), P(), P()),
                check_vma=False,
            )
        )
        return epoch

    epoch = jax.jit(_epoch_body)

    if not chunk_updates:
        return epoch

    # ---- chunked mode: same phases, partitioned into bounded programs ----
    c = int(chunk_updates)
    pc = int(plan_chunk) if plan_chunk else critic_plan_batch

    seg_collect = jax.jit(_collect)
    seg_insert = jax.jit(
        lambda replay, xs, us: replay.add_trajectories(xs, us)
    )

    def _chunked_collect(params, replay, k_collect):
        if collect_chunk_steps <= 0:
            return seg_collect(params, replay, k_collect)
        # long-episode collection in bounded programs: whole-episode
        # seg_collect is ONE program (episode_steps plan-steps);
        # chunked_batched_rollout bounds each
        # program to collect_chunk_steps with per-step semantics intact
        from gan_mpc_tpu.envs.rollout import chunked_batched_rollout

        episode = chunked_batched_rollout(
            env,
            env_params,
            policy.act,
            params,
            normalizer,
            k_collect,
            num_steps=episode_steps,
            history=history,
            num_envs=num_envs,
            chunk_steps=int(collect_chunk_steps),
            action_noise=collect_noise,
        )
        ep_return = jnp.mean(jnp.sum(episode.rewards, axis=-1))
        replay = seg_insert(
            replay,
            normalizer.normalize_state(episode.states),
            normalizer.normalize_action(episode.actions),
        )
        return replay, ep_return

    seg_fakes = jax.jit(_make_fakes)
    seg_polyak = jax.jit(lambda a, b: polyak_blend(a, b, polyak_factor))
    seg_gen = jax.jit(_gen_scan)
    if have_test:
        seg_test = jax.jit(_test_metrics)

    @jax.jit
    def seg_dyn(params, dyn_state, replay, perm, teacher_forcing):
        return _scan_updates(
            params,
            optimizers["dynamics"],
            dyn_state,
            _dyn_loss_of(replay, teacher_forcing),
            perm,
        )

    @jax.jit
    def seg_exp_dyn(params, dyn_state, perm):
        return _scan_updates(
            params, optimizers["dynamics"], dyn_state, _exp_dyn_loss, perm
        )

    @jax.jit
    def seg_critic(params, crit_state, seqs, labels, perm):
        return _scan_updates(
            params,
            optimizers["critic"],
            crit_state,
            _critic_loss_of(seqs, labels),
            perm,
        )

    def chunked_epoch(
        params, opt_states, replay: ReplayBuffer, key, teacher_forcing
    ):
        (
            k_collect,
            k_dyn,
            k_crit_idx,
            k_crit_perm,
            k_cost,
            k_shuffle,
        ) = jax.random.split(key, 6)

        replay, ep_return = _chunked_collect(params, replay, k_collect)

        dyn_perm = jax.random.randint(
            k_dyn,
            (dynamics_updates * steps_per_update, batch_size),
            0,
            jnp.maximum(replay.size, 1),
        )
        dyn_state = opt_states["dynamics"]
        parts = []
        for s, e in _chunks(dyn_perm.shape[0], c):
            params, dyn_state, l = seg_dyn(
                params, dyn_state, replay, dyn_perm[s:e], teacher_forcing
            )
            parts.append((l, e - s))
        dyn_loss = _wmean(parts)

        if have_exp_dyn:
            exp_perm = jax.random.randint(
                jax.random.fold_in(k_dyn, 1),
                (expert_dyn_updates, batch_size),
                0,
                edX.shape[0],
            )
            for s, e in _chunks(expert_dyn_updates, c):
                params, dyn_state, _ = seg_exp_dyn(
                    params, dyn_state, exp_perm[s:e]
                )

        plan_idx = jax.random.choice(
            k_crit_idx,
            exp_X.shape[0],
            shape=(critic_plan_batch,),
            replace=False,
        )
        fake_Y = jnp.concatenate(
            [
                seg_fakes(params, exp_X[plan_idx[s:e]])
                for s, e in _chunks(critic_plan_batch, pc)
            ]
        )
        seqs = jnp.concatenate([exp_Y[plan_idx], fake_Y], axis=0)
        labels = jnp.concatenate(
            [
                jnp.ones((critic_plan_batch,), jnp.float32),
                -jnp.ones((critic_plan_batch,), jnp.float32),
            ]
        )
        shuffle = jax.random.permutation(k_shuffle, 2 * critic_plan_batch)
        seqs, labels = seqs[shuffle], labels[shuffle]

        crit_perm = jax.random.randint(
            k_crit_perm,
            (critic_updates, batch_size),
            0,
            2 * critic_plan_batch,
        )
        crit_state = opt_states["critic"]
        parts = []
        for s, e in _chunks(critic_updates, c):
            params, crit_state, l = seg_critic(
                params, crit_state, seqs, labels, crit_perm[s:e]
            )
            parts.append((l, e - s))
        crit_loss = _wmean(parts)

        prev_params = params
        cost_perm = minibatch_indices(
            k_cost, exp_X.shape[0], cost_updates, batch_size
        )
        cost_state = opt_states["cost"]
        parts = []
        for s, e in _chunks(cost_updates, c):
            params, cost_state, l = seg_gen(
                params, cost_state, cost_perm[s:e]
            )
            parts.append((l, e - s))
        gen_loss = _wmean(parts)
        params = seg_polyak(prev_params, params)

        if have_test:
            fake_test = jnp.concatenate(
                [
                    seg_fakes(params, tX[s:e])
                    for s, e in _chunks(tX.shape[0], pc)
                ]
            )
            crit_test, gen_test = seg_test(params, fake_test)
        else:
            crit_test = jnp.float32(0.0)
            gen_test = jnp.float32(0.0)

        opt_states = {
            "dynamics": dyn_state,
            "critic": crit_state,
            "cost": cost_state,
        }
        metrics = FusedEpochMetrics(
            episode_return=ep_return,
            dynamics_loss=dyn_loss,
            critic_loss=crit_loss,
            generator_loss=gen_loss,
            critic_test_loss=crit_test,
            generator_test_loss=gen_test,
        )
        return params, opt_states, replay, metrics

    return chunked_epoch


def make_fused_l2_epoch(
    policy,
    env,
    env_params,
    normalizer,
    optimizers: dict,  # {"dynamics": tx, "cost": tx}
    expert_history_X,  # (N, history+1, x) normalized expert histories
    expert_future_Y,  # (N, horizon+1, x) normalized expert futures
    *,
    num_envs: int,
    episode_steps: int,
    history: int,
    dynamics_updates: int,
    cost_updates: int,
    batch_size: int,
    gamma: float,
    polyak_factor: float,
    expert_history_X_test=None,
    expert_future_Y_test=None,
    test_plan_batch: int = 64,
    expert_dyn_windows=None,  # (X, U, Y) expert sequence windows
    expert_dyn_updates: int = 0,
    chunk_updates: int = 0,
    plan_chunk: int = 0,
    collect_noise: float = 0.0,
    collect_chunk_steps: int = 0,
    mesh=None,
    dp_axis: str = "dp",
):
    """Fused single-program L2-MPC epoch: collection -> dynamics updates
    -> bilevel L2 cost updates (+ Polyak), the L2 counterpart of
    ``make_fused_gan_epoch`` (``/root/reference/norm/runner.py:101-145``
    as one XLA program). ``chunk_updates``/``plan_chunk`` select the
    chunked mode (see module docstring); ``mesh`` the
    data-parallel shard_map mode (same contract as the GAN epoch)."""
    from gan_mpc_tpu.policies.losses import l2_imitation_loss

    exp_X = jnp.asarray(expert_history_X)
    exp_Y = jnp.asarray(expert_future_Y)
    have_test = expert_history_X_test is not None
    if have_test:
        tX = jnp.asarray(expert_history_X_test)[:test_plan_batch]
        tY = jnp.asarray(expert_future_Y_test)[:test_plan_batch]
    have_exp_dyn = expert_dyn_windows is not None and expert_dyn_updates > 0
    if have_exp_dyn:
        edX, edU, edY = (jnp.asarray(a) for a in expert_dyn_windows)
    steps_per_update = max(exp_X.shape[0] // batch_size, 1)

    if mesh is not None:
        if chunk_updates:
            raise ValueError(
                "fused epoch: mesh mode and chunk_updates are exclusive"
            )
        num_dev = int(mesh.shape[dp_axis])
        for name, v in (
            ("num_envs", num_envs),
            ("batch_size", batch_size),
        ):
            if v % num_dev:
                raise ValueError(
                    f"fused epoch mesh mode: {name}={v} must divide the "
                    f"{dp_axis} axis size {num_dev}"
                )
    else:
        num_dev = 1

    def _pmean(x):
        return jax.lax.pmean(x, dp_axis) if mesh is not None else x

    def _gather(x):
        if mesh is None:
            return x
        return jax.lax.all_gather(x, dp_axis, axis=0, tiled=True)

    def _rows(x):
        if mesh is None:
            return x
        n = x.shape[0] // num_dev
        return jax.lax.dynamic_slice_in_dim(
            x, jax.lax.axis_index(dp_axis) * n, n
        )

    def _scan_updates(params, opt, opt_state, loss_of_batch, perm):
        def body(carry, p):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_of_batch)(params, _rows(p))
            loss, grads = _pmean(loss), _pmean(grads)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), perm
        )
        return params, opt_state, jnp.mean(losses)

    # ---- phase bodies, shared by the single-program and chunked modes ----

    def _collect(params, replay, key):
        env_keys = _rows(jax.random.split(key, num_envs))
        episode = policy_rollout(
            env,
            env_params,
            policy,
            params,
            normalizer,
            key,
            num_steps=episode_steps,
            history=history,
            num_envs=num_envs // num_dev,
            action_noise=collect_noise,
            env_keys=env_keys,
        )
        ep_return = _pmean(jnp.mean(jnp.sum(episode.rewards, axis=-1)))
        replay = replay.add_trajectories(
            _gather(normalizer.normalize_state(episode.states)),
            _gather(normalizer.normalize_action(episode.actions)),
        )
        return replay, ep_return

    def _dyn_loss_of(replay, teacher_forcing):
        def dyn_batch_loss(params, idx):
            X, U, Y = (
                replay.states[idx],
                replay.actions[idx],
                replay.next_states[idx],
            )
            losses = jax.vmap(
                lambda x, u, y: multistep_prediction_loss(
                    policy.dynamics_model,
                    params["dynamics_params"],
                    x,
                    u,
                    y,
                    gamma,
                    teacher_forcing,
                )
            )(X, U, Y)
            return jnp.mean(losses)

        return dyn_batch_loss

    def _exp_dyn_loss(params, idx):
        losses = jax.vmap(
            lambda x, u, y: multistep_prediction_loss(
                policy.dynamics_model,
                params["dynamics_params"],
                x,
                u,
                y,
                gamma,
                jnp.asarray(True),
            )
        )(edX[idx], edU[idx], edY[idx])
        return jnp.mean(losses)

    def _cost_scan(params, cost_state, perm):
        def cost_update(carry, idx):
            params, opt_state = carry
            idx_local = _rows(idx)
            loss, grads = policy.batched_loss_and_grad(
                params, exp_X[idx_local], l2_imitation_loss,
                (exp_Y[idx_local],),
            )
            loss, grads = _pmean(loss), _pmean(grads)
            updates, opt_state = optimizers["cost"].update(
                grads, opt_state, params
            )
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, cost_state), cost_losses = jax.lax.scan(
            cost_update, (params, cost_state), perm
        )
        return params, cost_state, jnp.mean(cost_losses)

    def _test_metric(params, hX, hY):
        def test_loss_one(hx, y):
            zeros_u = jnp.zeros(
                (hx.shape[0] - 1, policy.expert_model.u_size),
                jnp.float32,
            )
            sol = policy.plan(params, hx, zeros_u, warm_start_carry=False)
            return l2_imitation_loss(policy, sol, params, y)

        return jnp.mean(jax.vmap(test_loss_one)(hX, hY))

    def _epoch_body(
        params, opt_states, replay: ReplayBuffer, key, teacher_forcing
    ):
        k_collect, k_dyn, k_cost = jax.random.split(key, 3)

        replay, ep_return = _collect(params, replay, k_collect)

        dyn_perm = jax.random.randint(
            k_dyn,
            (dynamics_updates * steps_per_update, batch_size),
            0,
            jnp.maximum(replay.size, 1),
        )
        params, dyn_state, dyn_loss = _scan_updates(
            params,
            optimizers["dynamics"],
            opt_states["dynamics"],
            _dyn_loss_of(replay, teacher_forcing),
            dyn_perm,
        )

        if have_exp_dyn:
            exp_perm = jax.random.randint(
                jax.random.fold_in(k_dyn, 1),
                (expert_dyn_updates, batch_size),
                0,
                edX.shape[0],
            )
            params, dyn_state, _ = _scan_updates(
                params,
                optimizers["dynamics"],
                dyn_state,
                _exp_dyn_loss,
                exp_perm,
            )

        prev_params = params
        cost_perm = minibatch_indices(
            k_cost, exp_X.shape[0], cost_updates, batch_size
        )
        params, cost_state, cost_loss = _cost_scan(
            params, opt_states["cost"], cost_perm
        )
        params = polyak_blend(prev_params, params, polyak_factor)

        if have_test:
            cost_test = _test_metric(params, tX, tY)
        else:
            cost_test = jnp.float32(0.0)

        opt_states = {"dynamics": dyn_state, "cost": cost_state}
        metrics = FusedL2Metrics(
            episode_return=ep_return,
            dynamics_loss=dyn_loss,
            cost_loss=cost_loss,
            cost_test_loss=cost_test,
        )
        return params, opt_states, replay, metrics

    if mesh is not None:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        epoch = jax.jit(
            shard_map(
                _epoch_body,
                mesh=mesh,
                in_specs=(P(), P(), P(), P(), P()),
                out_specs=(P(), P(), P(), P()),
                check_vma=False,
            )
        )
        return epoch

    epoch = jax.jit(_epoch_body)

    if not chunk_updates:
        return epoch

    # ---- chunked mode: same phases, partitioned into bounded programs ----
    c = int(chunk_updates)
    pc = int(plan_chunk) if plan_chunk else test_plan_batch

    seg_collect = jax.jit(_collect)
    seg_insert = jax.jit(
        lambda replay, xs, us: replay.add_trajectories(xs, us)
    )

    def _chunked_collect(params, replay, k_collect):
        # see the GAN chunked section: bounded-program long collection
        if collect_chunk_steps <= 0:
            return seg_collect(params, replay, k_collect)
        from gan_mpc_tpu.envs.rollout import chunked_batched_rollout

        episode = chunked_batched_rollout(
            env,
            env_params,
            policy.act,
            params,
            normalizer,
            k_collect,
            num_steps=episode_steps,
            history=history,
            num_envs=num_envs,
            chunk_steps=int(collect_chunk_steps),
            action_noise=collect_noise,
        )
        ep_return = jnp.mean(jnp.sum(episode.rewards, axis=-1))
        replay = seg_insert(
            replay,
            normalizer.normalize_state(episode.states),
            normalizer.normalize_action(episode.actions),
        )
        return replay, ep_return

    seg_cost = jax.jit(_cost_scan)
    seg_polyak = jax.jit(lambda a, b: polyak_blend(a, b, polyak_factor))
    if have_test:
        seg_test = jax.jit(_test_metric)

    @jax.jit
    def seg_dyn(params, dyn_state, replay, perm, teacher_forcing):
        return _scan_updates(
            params,
            optimizers["dynamics"],
            dyn_state,
            _dyn_loss_of(replay, teacher_forcing),
            perm,
        )

    @jax.jit
    def seg_exp_dyn(params, dyn_state, perm):
        return _scan_updates(
            params, optimizers["dynamics"], dyn_state, _exp_dyn_loss, perm
        )

    def chunked_epoch(
        params, opt_states, replay: ReplayBuffer, key, teacher_forcing
    ):
        k_collect, k_dyn, k_cost = jax.random.split(key, 3)

        replay, ep_return = _chunked_collect(params, replay, k_collect)

        dyn_perm = jax.random.randint(
            k_dyn,
            (dynamics_updates * steps_per_update, batch_size),
            0,
            jnp.maximum(replay.size, 1),
        )
        dyn_state = opt_states["dynamics"]
        parts = []
        for s, e in _chunks(dyn_perm.shape[0], c):
            params, dyn_state, l = seg_dyn(
                params, dyn_state, replay, dyn_perm[s:e], teacher_forcing
            )
            parts.append((l, e - s))
        dyn_loss = _wmean(parts)

        if have_exp_dyn:
            exp_perm = jax.random.randint(
                jax.random.fold_in(k_dyn, 1),
                (expert_dyn_updates, batch_size),
                0,
                edX.shape[0],
            )
            for s, e in _chunks(expert_dyn_updates, c):
                params, dyn_state, _ = seg_exp_dyn(
                    params, dyn_state, exp_perm[s:e]
                )

        prev_params = params
        cost_perm = minibatch_indices(
            k_cost, exp_X.shape[0], cost_updates, batch_size
        )
        cost_state = opt_states["cost"]
        parts = []
        for s, e in _chunks(cost_updates, c):
            params, cost_state, l = seg_cost(
                params, cost_state, cost_perm[s:e]
            )
            parts.append((l, e - s))
        cost_loss = _wmean(parts)
        params = seg_polyak(prev_params, params)

        if have_test:
            chunk_tests = [
                (seg_test(params, tX[s:e], tY[s:e]), e - s)
                for s, e in _chunks(tX.shape[0], pc)
            ]
            cost_test = _wmean(chunk_tests)
        else:
            cost_test = jnp.float32(0.0)

        opt_states = {"dynamics": dyn_state, "cost": cost_state}
        metrics = FusedL2Metrics(
            episode_return=ep_return,
            dynamics_loss=dyn_loss,
            cost_loss=cost_loss,
            cost_test_loss=cost_test,
        )
        return params, opt_states, replay, metrics

    return chunked_epoch
