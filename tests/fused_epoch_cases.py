"""The fused single-program GAN/L2 epochs must run NaN-free and update
every trainable component, with the whole epoch inside one jit.

Round 1 had to skip this on the CPU harness (an XLA:CPU bug left LAPACK
FFI custom calls unregistered inside this large fused module). The
planner's solves are now custom-call-free (planner/linalg.py), so it
runs on every backend.
"""

import jax
import jax.numpy as jnp

from gan_mpc_tpu.data.buffers import ReplayBuffer
from gan_mpc_tpu.data.normalizer import Normalizer
from gan_mpc_tpu.envs import PendulumSwingup
from gan_mpc_tpu.models import (
    CostFeatureNet,
    ExpertPredictor,
    LearnedDynamics,
    MPCCost,
    ResidualMLPDynamicsNet,
    SequenceCritic,
)
from gan_mpc_tpu.planner import SolverSettings
from gan_mpc_tpu.policies import MPCPolicy
from gan_mpc_tpu.training.fused_epoch import make_fused_gan_epoch
from gan_mpc_tpu.training.masking import masked_adam

KEY = jax.random.PRNGKey(0)
H = 3

import pytest


@pytest.fixture(scope="module")
def gan_setup():
    """One shared GAN fused-epoch setup: policy, data, and the compiled
    SINGLE-program epoch with its first-epoch output. Both GAN fused
    tests consume it, so the expensive epoch program compiles once."""
    env = PendulumSwingup()
    x, u = env.obs_size, env.act_size
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(hidden=(8,), features_out=2), H),
        dynamics_model=LearnedDynamics(
            ResidualMLPDynamicsNet(x_size=x, hidden=(16,))
        ),
        expert_model=ExpertPredictor(
            x_size=x, u_size=u, arch="mlp", features=0, hidden=(8,)
        ),
        critic_model=SequenceCritic(features=8, hidden=(8,)),
        horizon=H,
        settings=SolverSettings(max_iterations=3),
    )
    params = policy.init(KEY, (-2.0, 3.0, -3.0), u, critic_x_size=x)
    norm = Normalizer.identity(x, u)
    opts = {
        "dynamics": masked_adam(
            params,
            ["mpc_weights", "cost_params", "critic_params", "expert_params"],
            1e-3,
        )[0],
        "critic": masked_adam(
            params,
            ["mpc_weights", "cost_params", "dynamics_params", "expert_params"],
            1e-3,
        )[0],
        "cost": masked_adam(
            params, ["dynamics_params", "critic_params", "expert_params"],
            1e-4,
        )[0],
    }
    opt_states = {k: opt.init(params) for k, opt in opts.items()}
    n_windows = 16
    exp_X = 0.1 * jax.random.normal(KEY, (n_windows, 2, x))
    exp_Y = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), (n_windows, H + 1, x)
    )
    kwargs = dict(
        num_envs=2, episode_steps=6, history=1,
        dynamics_updates=2, critic_updates=3, cost_updates=3,
        batch_size=4, gamma=0.9, polyak_factor=0.9, critic_plan_batch=4,
        expert_history_X_test=exp_X[:3], expert_future_Y_test=exp_Y[:3],
        expert_dyn_windows=(
            exp_Y[:, : H - 1], 0.1 * exp_Y[:, : H - 1, :u], exp_Y[:, 1:H]
        ),
        expert_dyn_updates=2,
    )
    args = (env, env.default_params(), norm, opts, exp_X, exp_Y)
    epoch = make_fused_gan_epoch(policy, *args, **kwargs)
    replay0 = ReplayBuffer.create(64, H, x, u)
    out1 = epoch(params, opt_states, replay0, KEY, jnp.asarray(True))
    return dict(
        policy=policy, params=params, opt_states=opt_states, args=args,
        kwargs=kwargs, epoch=epoch, replay0=replay0, out1=out1, x=x, u=u,
    )


def test_fused_gan_epoch_runs_and_learns(gan_setup):
    p0 = gan_setup["params"]
    params, opt_states, replay, m = gan_setup["out1"]
    for v in m:
        assert bool(jnp.isfinite(v)), m
    assert int(replay.size) > 0
    # dynamics and critic moved; cost moved (after polyak, 10% of step)
    for comp in ("dynamics_params", "critic_params", "cost_params"):
        moved = jax.tree_util.tree_map(
            lambda a, b: float(jnp.abs(a - b).max()), p0[comp], params[comp]
        )
        assert max(jax.tree_util.tree_leaves(moved)) > 0.0, comp
    # expert params frozen everywhere
    moved = jax.tree_util.tree_map(
        lambda a, b: float(jnp.abs(a - b).max()),
        p0["expert_params"],
        params["expert_params"],
    )
    assert max(jax.tree_util.tree_leaves(moved)) == 0.0
    # second epoch reuses the compiled program (no retrace errors)
    params, opt_states, replay, m2 = gan_setup["epoch"](
        params, opt_states, replay, jax.random.PRNGKey(2), jnp.asarray(False)
    )
    assert bool(jnp.isfinite(m2.generator_loss))


def test_fused_gan_epoch_chunked_matches_single_program(gan_setup):
    """chunk_updates partitions the epoch into bounded programs with
    IDENTICAL numerics: same update sequence, same
    RNG streams, merely split at program boundaries. Compared against
    the shared fixture's single-program first epoch."""
    chunked = make_fused_gan_epoch(
        gan_setup["policy"], *gan_setup["args"], **gan_setup["kwargs"],
        chunk_updates=2, plan_chunk=3,
    )
    out_c = chunked(
        gan_setup["params"], gan_setup["opt_states"], gan_setup["replay0"],
        KEY, jnp.asarray(True),
    )
    out_s = gan_setup["out1"]
    for ps, pc in zip(
        jax.tree_util.tree_leaves(out_s[0]),
        jax.tree_util.tree_leaves(out_c[0]),
    ):
        assert jnp.allclose(ps, pc, atol=2e-5), "params diverged"
    for name, vs, vc in zip(out_s[3]._fields, out_s[3], out_c[3]):
        assert jnp.allclose(vs, vc, atol=2e-5), (name, vs, vc)


def test_fused_gan_epoch_chunked_collection_runs(gan_setup):
    """collect_chunk_steps bounds the collection program at humanoid
    scale (H=50 long episodes). Different PRNG layout than the
    in-program collection (chunked_batched_rollout), so this asserts
    health, not equality."""
    chunked = make_fused_gan_epoch(
        gan_setup["policy"], *gan_setup["args"], **gan_setup["kwargs"],
        chunk_updates=2, plan_chunk=3, collect_chunk_steps=3,
    )
    params, opt_states, replay, m = chunked(
        gan_setup["params"], gan_setup["opt_states"], gan_setup["replay0"],
        KEY, jnp.asarray(True),
    )
    for v in m:
        assert bool(jnp.isfinite(v)), m
    assert int(replay.size) > 0


def test_fused_gan_epoch_mesh_matches_single_device(gan_setup):
    """The dp-mesh fused epoch (shard_map: sharded collection keys,
    minibatch shards + pmean grads, all_gather'd planning fan-outs) must
    reproduce the single-device epoch to fp reduction order — SAME code
    path the flagship configs train with, now multi-chip (VERDICT r3
    item 5). Test split resized to divide the mesh."""
    from gan_mpc_tpu.parallel import make_mesh

    kwargs = dict(gan_setup["kwargs"])
    exp_X = gan_setup["args"][4]
    exp_Y = gan_setup["args"][5]
    kwargs["expert_history_X_test"] = exp_X[:4]
    kwargs["expert_future_Y_test"] = exp_Y[:4]
    single = make_fused_gan_epoch(
        gan_setup["policy"], *gan_setup["args"], **kwargs
    )
    mesh = make_mesh(2)
    sharded = make_fused_gan_epoch(
        gan_setup["policy"], *gan_setup["args"], **kwargs, mesh=mesh
    )
    args = (
        gan_setup["params"], gan_setup["opt_states"], gan_setup["replay0"],
        KEY, jnp.asarray(True),
    )
    out_s, out_m = single(*args), sharded(*args)
    # identical episodes -> identical replay content
    for rs, rm in zip(
        jax.tree_util.tree_leaves(out_s[2]),
        jax.tree_util.tree_leaves(out_m[2]),
    ):
        assert jnp.allclose(rs, rm, atol=1e-5), "replay diverged"
    for ps, pm in zip(
        jax.tree_util.tree_leaves(out_s[0]),
        jax.tree_util.tree_leaves(out_m[0]),
    ):
        assert jnp.allclose(ps, pm, atol=5e-5), "params diverged"
    for name, vs, vm in zip(out_s[3]._fields, out_s[3], out_m[3]):
        assert jnp.allclose(vs, vm, atol=5e-4, rtol=1e-3), (name, vs, vm)


def _l2_setup():
    from gan_mpc_tpu.training.fused_epoch import make_fused_l2_epoch

    env = PendulumSwingup()
    x, u = env.obs_size, env.act_size
    policy = MPCPolicy(
        cost_model=MPCCost(CostFeatureNet(hidden=(8,), features_out=2), H),
        dynamics_model=LearnedDynamics(
            ResidualMLPDynamicsNet(x_size=x, hidden=(16,))
        ),
        expert_model=ExpertPredictor(
            x_size=x, u_size=u, arch="mlp", features=0, hidden=(8,)
        ),
        horizon=H,
        settings=SolverSettings(max_iterations=3),
    )
    params = policy.init(KEY, (-2.0, 3.0, -3.0), u)
    norm = Normalizer.identity(x, u)
    replay = ReplayBuffer.create(64, H, x, u)
    opts = {
        "dynamics": masked_adam(
            params, ["mpc_weights", "cost_params", "expert_params"], 1e-3
        )[0],
        "cost": masked_adam(
            params, ["dynamics_params", "expert_params"], 1e-4
        )[0],
    }
    opt_states = {k: opt.init(params) for k, opt in opts.items()}
    n_windows = 16
    exp_X = 0.1 * jax.random.normal(KEY, (n_windows, 2, x))
    exp_Y = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), (n_windows, H + 1, x)
    )
    args = (policy, env, env.default_params(), norm, opts, exp_X, exp_Y)
    kwargs = dict(
        num_envs=2, episode_steps=6, history=1,
        dynamics_updates=1, cost_updates=1,
        batch_size=4, gamma=0.9, polyak_factor=0.9,
        expert_history_X_test=exp_X[:4], expert_future_Y_test=exp_Y[:4],
    )
    epoch = make_fused_l2_epoch(*args, **kwargs)
    return dict(
        make=make_fused_l2_epoch, args=args, kwargs=kwargs, epoch=epoch,
        params=params, opt_states=opt_states, replay0=replay,
    )


def test_fused_l2_epoch_runs_and_learns():
    s = _l2_setup()
    p0 = s["params"]
    params, opt_states, replay, m = s["epoch"](
        p0, s["opt_states"], s["replay0"], KEY, jnp.asarray(True)
    )
    for v in m:
        assert bool(jnp.isfinite(v)), m
    assert float(m.cost_test_loss) > 0.0  # held-out metric real, not padded
    for comp in ("dynamics_params", "cost_params"):
        moved = jax.tree_util.tree_map(
            lambda a, b: float(jnp.abs(a - b).max()), p0[comp], params[comp]
        )
        assert max(jax.tree_util.tree_leaves(moved)) > 0.0, comp


def test_fused_l2_epoch_mesh_matches_single_device():
    from gan_mpc_tpu.parallel import make_mesh

    s = _l2_setup()
    sharded = s["make"](*s["args"], **s["kwargs"], mesh=make_mesh(2))
    call_args = (
        s["params"], s["opt_states"], s["replay0"], KEY, jnp.asarray(True)
    )
    out_s, out_m = s["epoch"](*call_args), sharded(*call_args)
    for ps, pm in zip(
        jax.tree_util.tree_leaves(out_s[0]),
        jax.tree_util.tree_leaves(out_m[0]),
    ):
        assert jnp.allclose(ps, pm, atol=5e-5), "params diverged"
    for name, vs, vm in zip(out_s[3]._fields, out_s[3], out_m[3]):
        assert jnp.allclose(vs, vm, atol=5e-4, rtol=1e-3), (name, vs, vm)
