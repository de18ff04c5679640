"""Config-driven factories and shared runner plumbing.

Capability parity with the reference's wiring layer
(``/root/reference/utils.py:169-227`` model factories +
``norm/runner.py:13-76`` policy/optimizer/normalizer assembly).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.data.normalizer import Normalizer
from gan_mpc_tpu.data.trajectories import (
    TrajectorySet,
    load_trajectories,
    save_trajectories,
)
from gan_mpc_tpu.envs import apply_physics_shift, make_env
from gan_mpc_tpu.models import (
    CostFeatureNet,
    ExpertPredictor,
    LearnedDynamics,
    LSTMDynamicsNet,
    MPCCost,
    ResidualMLPDynamicsNet,
    SequenceCritic,
)
from gan_mpc_tpu.planner import SolverSettings
from gan_mpc_tpu.policies import MPCPolicy
from gan_mpc_tpu.runners import collect


def build_cost_model(config: Config, horizon: int) -> MPCCost:
    mlp = config.mpc.model.cost.mlp
    net = CostFeatureNet(
        hidden=tuple(mlp.hidden), features_out=mlp.features_out
    )
    ccfg = config.mpc.model.cost
    return MPCCost(
        net,
        horizon=horizon,
        action_goal_scale=float(ccfg.get_path("action_goal_scale", 1.0)),
        action_goal_squared=bool(ccfg.get_path("action_goal_squared", False)),
    )


def build_dynamics_model(config: Config, x_size: int) -> LearnedDynamics:
    mcfg = config.mpc.model.dynamics
    if mcfg.use == "mlp":
        net = ResidualMLPDynamicsNet(
            x_size=x_size, hidden=tuple(mcfg.mlp.hidden)
        )
    elif mcfg.use == "lstm":
        net = LSTMDynamicsNet(
            x_size=x_size,
            features=mcfg.lstm.features,
            hidden=tuple(mcfg.lstm.hidden),
        )
    elif mcfg.use == "ensemble":
        from gan_mpc_tpu.models.ensemble import EnsembleDynamics

        ecfg = mcfg.ensemble
        net = ResidualMLPDynamicsNet(
            x_size=x_size, hidden=tuple(ecfg.mlp.hidden)
        )
        return EnsembleDynamics(net, num_members=ecfg.num_members)
    else:
        raise ValueError(
            f"dynamics.use must be mlp|lstm|ensemble, got {mcfg.use!r}"
        )
    return LearnedDynamics(net)


def build_expert_model_from_dict(
    mdict: dict, x_size: int, u_size: int
) -> ExpertPredictor:
    """Expert predictor from a plain model-config dict — the schema saved
    into each expert run's ``config.json``, so saved models are rebuilt
    from THEIR OWN architecture regardless of the current YAML
    (``/root/reference/utils.py:216-227`` reloads saved configs the same
    way)."""
    use = mdict["use"]
    if use == "lstm":
        return ExpertPredictor(
            x_size=x_size,
            u_size=u_size,
            arch="lstm",
            features=mdict["lstm"]["features"],
            hidden=tuple(mdict["lstm"]["hidden"]),
        )
    if use == "mlp":
        return ExpertPredictor(
            x_size=x_size,
            u_size=u_size,
            arch="mlp",
            features=0,
            hidden=tuple(mdict["mlp"]["hidden"]),
        )
    raise ValueError(f"expert model.use must be mlp|lstm, got {use!r}")


def build_expert_model(
    config: Config, x_size: int, u_size: int
) -> ExpertPredictor:
    return build_expert_model_from_dict(
        config.expert_prediction.model.to_dict(), x_size, u_size
    )


def build_critic_model(config: Config) -> SequenceCritic:
    mcfg = config.mpc.model.critic
    if mcfg.use != "lstm":
        raise ValueError("critic supports only the lstm architecture")
    return SequenceCritic(
        features=mcfg.lstm.features, hidden=tuple(mcfg.lstm.hidden)
    )


def solver_settings(config: Config) -> SolverSettings:
    mpc = config.mpc
    horizon = mpc.get_path("horizon", 5)
    # fully unroll the inner length-T scans at short horizons (removes
    # loop overhead; bounded so long-horizon configs keep compile time)
    default_unroll = horizon if horizon <= 8 else 1
    return SolverSettings(
        max_iterations=mpc.get_path("solver.max_iterations", 100),
        grad_norm_tol=mpc.get_path("solver.grad_norm_tol", 1e-4),
        riccati=mpc.get_path("solver.riccati", "sequential"),
        inner_unroll=mpc.get_path("solver.inner_unroll", default_unroll),
        ls_materialize=mpc.get_path("solver.ls_materialize", "auto"),
    )


def build_policy(
    config: Config,
    x_size: int,
    u_size: int,
    with_critic: bool = False,
    expert_params=None,
    expert_model=None,
    key=None,
):
    """Returns (policy, params). ``expert_model`` overrides the
    current-config architecture — pass the model reconstructed from a
    saved run's own config.json when loading pretrained experts."""
    horizon = config.mpc.horizon
    policy = MPCPolicy(
        cost_model=build_cost_model(config, horizon),
        dynamics_model=build_dynamics_model(config, x_size),
        expert_model=(
            expert_model
            if expert_model is not None
            else build_expert_model(config, x_size, u_size)
        ),
        critic_model=build_critic_model(config) if with_critic else None,
        horizon=horizon,
        settings=solver_settings(config),
        bilevel_solver=config.get_path("mpc.solver.bilevel", "dense"),
        goal_projection=config.get_path("mpc.goal_projection_iters", 0),
    )
    weights_cfg = config.mpc.model.cost.weights
    mpc_weights = [weights_cfg.action, weights_cfg.state, weights_cfg.terminal]
    # optional 4th weight: action-GOAL tracking w3*huber(u - u_pred)
    # (models/cost.py stage) — presence in the config enables the term
    ag = weights_cfg.get_path("action_goal")
    if ag is not None:
        mpc_weights.append(ag)
        # optional 5th weight: action-goal GAIN alpha (raw, init ~1.0) —
        # the tracked target is alpha * u_pred (models/cost.py stage)
        gain = weights_cfg.get_path("action_goal_gain")
        if gain is not None:
            mpc_weights.append(gain)
    mpc_weights = tuple(mpc_weights)
    key = key if key is not None else jax.random.PRNGKey(config.seed)
    params = policy.init(
        key, mpc_weights, u_size, expert_params=expert_params,
        critic_x_size=x_size,
    )
    return policy, params


def build_normalizer(config: Config, trajs: TrajectorySet) -> Normalizer:
    ncfg = config.mpc.normalizer
    return Normalizer.fit(
        jnp.asarray(trajs.states),
        jnp.asarray(trajs.actions),
        normalize_state=(ncfg.state == "standard_norm"),
        normalize_action=(ncfg.action == "standard_norm"),
    )


def collection_fingerprint(config: Config) -> str:
    """Short hash of everything that determines the collected data: env
    physics constants (the env's default_params leaves — any physics
    change moves this) plus the collection knobs (episode length, noise,
    reset-velocity randomization, count, seed). A cached store collected
    under different physics or knobs would otherwise be silently reused
    and poison training."""
    import hashlib

    from gan_mpc_tpu.runners.collect import EXPERT_VERSION

    # Pure host-side bookkeeping: pin the param constants to the CPU
    # backend so computing a cache fingerprint never round-trips through
    # the accelerator (a hash must not depend on device health). Where
    # JAX has no cpu backend, the default device is the only choice.
    import contextlib

    try:
        cpu = jax.local_devices(backend="cpu")[0]
        device_ctx = jax.default_device(cpu)
    except RuntimeError:
        device_ctx = contextlib.nullcontext()
    with device_ctx:
        env = make_env(config.env.name)
        leaves = jax.tree_util.tree_leaves(env.default_params())
        payload = [config.env.name]
        payload += [f"{float(v):.9g}" for v in leaves]
    payload += [
        str(config.get_path("env.expert_episode_steps", 1000)),
        str(config.get_path("env.expert_noise", 0.25)),
        str(config.get_path("env.expert_reset_velocity", 0.0)),
        str(
            max(
                config.get_path(
                    "env.collect_trajectories",
                    config.mpc.train.num_trajectories,
                ),
                config.mpc.train.num_trajectories,
                4,
            )
        ),
        str(config.seed + 7),
        # bumped whenever a scripted expert's behavior changes: a cached
        # store labeled by an older expert must not be silently reused
        f"expert-v{EXPERT_VERSION.get(config.env.name, 1)}",
    ]
    return hashlib.sha256("|".join(payload).encode()).hexdigest()[:10]


def trajectories_path(config: Config) -> str:
    workdir = config.get_path("runtime.workdir", "runs")
    base = os.path.join(workdir, "expert_trajectories", config.env.name)
    # prefer the native C++ binary store when its library is available
    # (single-fwrite IO; data/native_store.py); .npz otherwise. An
    # existing store of either format wins so runs stay resumable.
    from gan_mpc_tpu.data import native_store

    fp = collection_fingerprint(config)
    gmts = os.path.join(base, f"trajectories-{fp}.gmts")
    npz = os.path.join(base, f"trajectories-{fp}.npz")
    if os.path.exists(gmts):
        return gmts
    if os.path.exists(npz):
        return npz
    # an unfingerprinted legacy store means the cache predates this
    # check: its physics/collection provenance is unknown — recollect.
    for legacy in ("trajectories.gmts", "trajectories.npz"):
        if os.path.exists(os.path.join(base, legacy)):
            print(
                f"[trajectories] ignoring legacy unfingerprinted store "
                f"{os.path.join(base, legacy)}; recollecting as "
                f"trajectories-{fp}.*"
            )
            break
    return gmts if native_store.available() else npz


def ensure_trajectories(config: Config) -> TrajectorySet:
    """Load expert trajectories; if absent, collect them with the scripted
    expert (the reference relies on an external RL pipeline here)."""
    path = config.get_path("env.trajectories_path") or trajectories_path(
        config
    )
    train_cfg = config.mpc.train
    min_reward = train_cfg.get_path("min_expert_reward", 500.0)
    if not os.path.exists(path):
        env = make_env(config.env.name)
        trajs = collect.collect_expert_trajectories(
            env,
            # collect_trajectories > num_trajectories oversamples so the
            # min_reward gate can drop bad episodes and still keep the
            # requested count (scripted experts are not fall-proof on the
            # harder envs, e.g. humanoid_walk)
            max(
                config.get_path(
                    "env.collect_trajectories", train_cfg.num_trajectories
                ),
                train_cfg.num_trajectories,
                4,
            ),
            jax.random.PRNGKey(config.seed + 7),
            num_steps=config.get_path("env.expert_episode_steps", 1000),
            noise_sigma=config.get_path("env.expert_noise", 0.25),
            reset_velocity_sigma=config.get_path(
                "env.expert_reset_velocity", 0.0
            ),
        )
        save_trajectories(path, trajs)
    out = load_trajectories(
        path,
        num_trajectories=train_cfg.num_trajectories,
        trajectory_len=train_cfg.trajectory_len,
        min_reward=min_reward,
    )
    if out.states.shape[0] < train_cfg.num_trajectories:
        # load_trajectories only errors at ZERO survivors; a silently
        # smaller demo set (noisy scripted expert + reward gate) would
        # otherwise skew training without a trace (ADVICE r3).
        print(
            f"[trajectories] WARNING: only {out.states.shape[0]} of the "
            f"requested {train_cfg.num_trajectories} trajectories clear "
            f"min_expert_reward={min_reward} in {path}; training "
            f"proceeds on the smaller set — raise "
            f"env.collect_trajectories to restore oversampling headroom"
        )
    return out


def maybe_mesh(config: Config):
    """A data-parallel mesh when ``runtime.data_parallel_devices`` > 1,
    else None (single-device). The fused epochs run the SAME program
    either way (training/fused_epoch.py mesh mode)."""
    n = int(config.get_path("runtime.data_parallel_devices", 1) or 1)
    if n <= 1:
        return None
    from gan_mpc_tpu.parallel import make_mesh

    if len(jax.devices()) < n:
        raise ValueError(
            f"runtime.data_parallel_devices={n} but only "
            f"{len(jax.devices())} devices are attached"
        )
    return make_mesh(n)


def load_run_config(run_dir: str, fallback: Config | None = None) -> Config:
    """Reconstruct the training Config of a SAVED run from its own
    ``config.json`` (schema written by runners/{l2,gan}.py: env + seed +
    ``policy`` = the mpc tree, and — for runs saved after round 4 —
    ``expert_prediction``). Probing a run with a drifted CLI config
    silently rebuilds the wrong policy/normalizer (ADVICE r3); this keeps
    eval/diag tools on the run's own provenance. ``fallback`` (a CLI
    config) fills sections older runs did not persist."""
    import json

    path = os.path.join(run_dir, "config.json")
    with open(path) as fp:
        saved = json.load(fp)
    tree = {
        "seed": saved.get("seed", 0),
        "env": saved["env"],
        "mpc": saved["policy"],
    }
    if "expert_prediction" in saved:
        tree["expert_prediction"] = saved["expert_prediction"]
    elif fallback is not None:
        tree["expert_prediction"] = fallback.expert_prediction.to_dict()
    else:
        raise ValueError(
            f"{path} predates expert_prediction provenance; pass the "
            f"training YAML as a fallback config"
        )
    fb = fallback.to_dict() if fallback is not None else {}
    tree["runtime"] = fb.get("runtime", {"workdir": "runs"})
    return Config.from_dict(tree)


def imitator_env(config: Config):
    """(env, shifted physics params) for the imitator domain
    (``/root/reference/utils.py:43-75``)."""
    icfg = config.env.imitator
    env = make_env(icfg.name)
    params = env.default_params()
    shifts = [dict(kv) for kv in (icfg.get_path("physics") or [])]
    if shifts:
        params = apply_physics_shift(params, shifts)
    return env, params


def expert_model_dir(config: Config) -> str:
    workdir = config.get_path("runtime.workdir", "runs")
    return os.path.join(workdir, "trained_models", "expert", config.env.name)


def imitator_model_dir(config: Config, family: str) -> str:
    workdir = config.get_path("runtime.workdir", "runs")
    return os.path.join(
        workdir, "trained_models", "imitator", config.env.name, family
    )


def record_solver_stats(metrics, policy, params, cost_test, epoch, n=32):
    """Plan on a small batch of held-out expert histories and record iLQR
    convergence diagnostics (iterations / converged fraction / objective)
    — the observability the reference computes but discards
    (``/root/reference/policy/optimizers.py:55``, iteration count unused).
    ``cost_test`` is the (X, Y) held-out cost split from setup()."""
    from gan_mpc_tpu.utils.metrics import solver_stats

    hX = cost_test[0][:n]
    hU = jnp.zeros(
        (hX.shape[0], hX.shape[1] - 1, policy.expert_model.u_size),
        jnp.float32,
    )
    sol = jax.jit(policy.plan_batch)(params, hX, hU)
    metrics.record(epoch, **solver_stats(sol))
