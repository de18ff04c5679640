"""Diagnostic: cheetah shifted-env ceiling with TRUE physics in the loop.

The open question (BENCHMARKS.md): GAN-MPC reaches 16.2 on the x3-torso
shifted env vs the open-loop gait expert's own 27.4. Is the binding
constraint (a) learned-dynamics error, or (b) the goals themselves
(expert gait states infeasible for the heavier body)?

This script plans through the TRUE (differentiable) SHIFTED physics —
zero model error — while keeping the shipped run's trained expert
predictor, cost net, and weights, and sweeps goal treatments:

  * raw        — predictor goals exactly as in training
  * proj2/6    — goals projected onto the TRUE dynamics' reachable set
                 (upper bound for mpc.goal_projection_iters)
  * stretch2   — half-speed goals: each goal held for 2 steps and goal
                 velocities halved (a heavier body may need a slower
                 gait than the demonstrated one)
  * learned    — sanity row: the shipped policy as-is (expect ~16)

If the true-physics rows stay near/below 27.4 the goals bind and the fix
is goal-side (predictor adaptation, time-warping); if they beat 27.4 the
gap is dynamics-model error and the fix is model-side.

Usage: python scripts/diag_cheetah_ceiling.py [config] [run_dir]
         [--envs N] [--steps N] [--variants a,b,c]
"""

import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

# persistent compile cache (gan_mpc_tpu/runtime_setup.py)
from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.config import Config
from gan_mpc_tpu.envs import base, make_env
from gan_mpc_tpu.envs.rollout import chunked_batched_rollout
from gan_mpc_tpu.planner import SolverSettings
from gan_mpc_tpu.policies.mpc import MPCPolicy
from gan_mpc_tpu.runners import common
from gan_mpc_tpu.utils import io

args = sys.argv[1:]


def _opt(name, default, cast):
    if name in args:
        return cast(args[args.index(name) + 1])
    return default


CFG = next(
    (a for a in args if a.endswith(".yaml")), "configs/gan_cheetah_quality.yaml"
)
RUN = next(
    (a for a in args if "/gan/" in a or "/l2/" in a),
    "runs/trained_models/imitator/cheetah_run/gan/0",
)
N_ENVS = _opt("--envs", 6, int)
N_STEPS = _opt("--steps", 1000, int)
# --weights "a,s,t[,ag]" overrides the loaded run's raw mpc_weights for
# the learned variants (operating-point sweep on fixed components)
W_OVERRIDE = _opt("--weights", None, str)
VARIANTS = _opt("--variants", "raw,proj2,stretch2,learned", str).split(",")


def main():
    config = Config.from_yaml(CFG)
    env = make_env(config.env.name)
    env_im, p_im = common.imitator_env(config)
    trajs = common.ensure_trajectories(config)
    norm = common.build_normalizer(config, trajs)
    policy, template = common.build_policy(
        config, env.obs_size, env.act_size, with_critic=True
    )
    params = io.load_params(template, RUN + "/params.msgpack")
    if W_OVERRIDE is not None:
        params = dict(params)
        params["mpc_weights"] = jnp.array(
            [float(v) for v in W_OVERRIDE.split(",")], dtype=jnp.float32
        )
        print("mpc_weights override:", params["mpc_weights"])
    mu, sd = norm.state_mean, norm.state_std

    class TrueShiftedDynamics:
        """True shifted-env physics as planner dynamics over the
        NORMALIZED observation [qpos[1:], qvel] (x dropped: translation
        invariance closes the obs dynamics)."""

        x_size = env.obs_size
        carry_size = 0
        is_batch_native = False

        def __call__(self, xc, u, t, theta):
            del theta
            raw = xc * sd + mu
            n = (env.obs_size + 1) // 2  # planar: obs = qpos[1:] ++ qvel
            qpos = jnp.concatenate([jnp.zeros((1,)), raw[: n - 1]])
            state = base.EnvState(
                qpos=qpos.astype(jnp.float32),
                qvel=raw[n - 1 :].astype(jnp.float32),
                t=jnp.asarray(0, dtype=jnp.int32),
            )
            new_state, _ = env_im.step(p_im, state, u)
            obs = env_im.observe(p_im, new_state)
            return (obs - mu) / sd

        def warm_carry(self, dparams, hist_x, hist_u):
            del dparams, hist_x, hist_u
            return jnp.zeros((0,), dtype=jnp.float32)

        def zero_carry(self):
            return jnp.zeros((0,), dtype=jnp.float32)

    def make_policy(dynamics, goal_projection=0, stretch=1):
        pol = MPCPolicy(
            policy.cost_model,
            dynamics,
            policy.expert_model,
            horizon=policy.horizon,
            settings=SolverSettings(
                max_iterations=int(
                    config.get_path("mpc.solver.max_iterations", 30)
                ),
                grad_norm_tol=float(
                    config.get_path("mpc.solver.grad_norm_tol", 1e-4)
                ),
            ),
            goal_projection=goal_projection,
        )
        if stretch > 1:
            inner = pol.goals_and_warm_start

            def stretched(p, history_x):
                goal_X, init_U = inner(p, history_x)
                H = goal_X.shape[0] - 1
                idx = jnp.concatenate(
                    [jnp.zeros((1,), jnp.int32),
                     1 + jnp.arange(H, dtype=jnp.int32) // stretch]
                )
                g = goal_X[idx]
                n = (env.obs_size + 1) // 2
                g = g.at[:, n - 1 :].multiply(1.0 / stretch)
                return g, init_U / stretch

            pol.goals_and_warm_start = stretched
        return pol

    def make_ureg_policy(lam, dynamics, directional=False, gain=1.0):
        """State-tracking stage cost PLUS lam*|u - u_pred|^2: the
        expert's cloned ACTIONS re-enter the objective, interpolating
        between pure state tracking (lam=0, measured 16.6 on true
        physics) and stabilized torque replay (lam->inf ~ the gait
        expert's own 27.4). A fixed test of the action-goal-cost idea
        before promoting it into MPCCost."""
        from gan_mpc_tpu.planner import make_implicit_planner

        cost_model, expert_model = policy.cost_model, policy.expert_model

        def stage(xc, u, t, theta, goal_X, goal_U):
            up = gain * goal_U[t]
            if directional:
                # penalize only the component of u ORTHOGONAL to the
                # cloned action direction: pattern like the expert,
                # amplitude free (the state goals set the amplitude)
                n2 = jnp.sum(up * up)
                uhat = up * jax.lax.rsqrt(n2 + 1e-8)
                du = u - jnp.dot(u, uhat) * uhat * (n2 > 1e-8)
            else:
                du = u - up
            return cost_model.stage(
                xc, u, t, theta["mpc_weights"], goal_X
            ) + lam * jnp.sum(du * du)

        def term(xc, theta, goal_X, goal_U):
            del goal_X, goal_U
            return cost_model.terminal(
                xc, theta["cost_params"], theta["mpc_weights"]
            )

        def dyn(xc, u, t, theta):
            return dynamics(xc, u, t, theta["dynamics_params"])

        plan = make_implicit_planner(
            stage, dyn,
            SolverSettings(
                max_iterations=int(
                    config.get_path("mpc.solver.max_iterations", 30)
                )
            ),
            terminal_cost=term,
        )

        class P:
            def act(self, p, hist_x, hist_u):
                carry = expert_model.warm_carry(p["expert_params"], hist_x)
                goal_X, init_U = expert_model.generate(
                    p["expert_params"], carry, policy.horizon
                )
                theta = {
                    "mpc_weights": p["mpc_weights"],
                    "cost_params": p["cost_params"],
                    "dynamics_params": p["dynamics_params"],
                }
                sol = plan(theta, hist_x[-1], init_U, (goal_X, init_U), ())
                return sol.U[0]

        return P()

    class UOnly:
        """Execute the predictor's warm-start action directly (BC
        endpoint, no planning)."""

        def act(self, p, hist_x, hist_u):
            carry = policy.expert_model.warm_carry(p["expert_params"], hist_x)
            _, init_U = policy.expert_model.generate(
                p["expert_params"], carry, policy.horizon
            )
            return init_U[0]

    builds = {
        "raw": lambda: make_policy(TrueShiftedDynamics()),
        "proj2": lambda: make_policy(TrueShiftedDynamics(), goal_projection=2),
        "proj6": lambda: make_policy(TrueShiftedDynamics(), goal_projection=6),
        "stretch2": lambda: make_policy(TrueShiftedDynamics(), stretch=2),
        "learned": lambda: make_policy(
            policy.dynamics_model,
            goal_projection=int(
                config.get_path("mpc.goal_projection_iters", 0)
            ),
        ),
        "learned_noproj": lambda: make_policy(policy.dynamics_model),
        "gait": lambda: type(
            "Gait",
            (),
            {
                "act": lambda self, p, hx, hu: collect.cheetah_gait_action(
                    GAIT_T.add_then_get(), env.dt
                )
            },
        )(),
        "uonly": lambda: UOnly(),
        "ureg1": lambda: make_ureg_policy(1.0, TrueShiftedDynamics()),
        "ureg5": lambda: make_ureg_policy(5.0, TrueShiftedDynamics()),
        "ureg20": lambda: make_ureg_policy(20.0, TrueShiftedDynamics()),
        "ureg5l": lambda: make_ureg_policy(5.0, policy.dynamics_model),
        "ureg20l": lambda: make_ureg_policy(20.0, policy.dynamics_model),
        "ureg50l": lambda: make_ureg_policy(50.0, policy.dynamics_model),
        "udir5l": lambda: make_ureg_policy(
            5.0, policy.dynamics_model, directional=True
        ),
        "udir20l": lambda: make_ureg_policy(
            20.0, policy.dynamics_model, directional=True
        ),
        "udir5": lambda: make_ureg_policy(
            5.0, TrueShiftedDynamics(), directional=True
        ),
        "ugain13": lambda: make_ureg_policy(
            5.0, policy.dynamics_model, gain=1.3
        ),
        "ugain15": lambda: make_ureg_policy(
            5.0, policy.dynamics_model, gain=1.5
        ),
    }
    results = {}
    for name in VARIANTS:
        pol = builds[name]()
        # chunked: one device program per 100 steps instead of the
        # 1000-step plan-through-true-physics scan as ONE program
        ep = chunked_batched_rollout(
            env_im,
            p_im,
            pol.act,
            params,
            norm,
            jax.random.PRNGKey(11),
            num_steps=N_STEPS,
            history=int(config.get_path("mpc.history", 1)),
            num_envs=N_ENVS,
            chunk_steps=100,
        )
        rets = jnp.sum(ep.rewards, axis=-1)
        results[name] = (float(jnp.mean(rets)), float(jnp.std(rets)))
        print(
            f"{name:9s}: return {results[name][0]:7.2f} "
            f"+- {results[name][1]:5.2f}  over {N_ENVS} x {N_STEPS} steps",
            flush=True,
        )
    print("\nsummary:", results)


if __name__ == "__main__":
    main()
