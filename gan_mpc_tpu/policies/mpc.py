"""The MPC policy: learned cost + learned dynamics + expert goal generator
wired into the differentiable iLQR planner.

Capability parity with the reference policy layer
(``/root/reference/policy/eval.py`` EvalMPC + ``policy/base.py`` BaseMPC),
unified into one class:

  * ``plan``/``act`` with history-warmed dynamics carry  == EvalMPC
    (inference hot path, ``eval.py:109-128``);
  * ``plan(..., warm_start_carry=False)`` with a zero carry == BaseMPC's
    train-time simplification (``base.py:31-38``);
  * ``batched_loss_and_grad`` == BaseMPC.loss_and_grad
    (``base.py:87-128``): vmapped differentiable planning, mean loss and
    mean grads over the batch — except here the bilevel gradient arrives
    through the planner's custom VJP, so the outer loss is ordinary JAX.

``params`` layout (same component split the reference uses so gradient
masking semantics carry over): ``{"mpc_weights", "cost_params",
"dynamics_params", "expert_params"[, "critic_params"]}``.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.cost import MPCCost
from gan_mpc_tpu.models.dynamics import LearnedDynamics
from gan_mpc_tpu.models.expert import ExpertPredictor
from gan_mpc_tpu.planner import SolverSettings, make_implicit_planner
from gan_mpc_tpu.planner.ilqr import ILQRSolution


class MPCPolicy:
    def __init__(
        self,
        cost_model: MPCCost,
        dynamics_model: LearnedDynamics,
        expert_model: ExpertPredictor,
        critic_model=None,
        horizon: int = 5,
        settings: SolverSettings = SolverSettings(),
        bilevel_solver: str = "dense",
        bilevel_ridge: float = 1e-5,
        goal_projection: int = 0,
    ):
        self.cost_model = cost_model
        self.dynamics_model = dynamics_model
        self.expert_model = expert_model
        self.critic_model = critic_model
        self.horizon = horizon
        self.x_size = dynamics_model.x_size
        self.settings = settings
        self.goal_projection = goal_projection

        # Stage and terminal costs split so the terminal net is evaluated
        # once per rollout, not at every step (the combined jnp.where form
        # pays both branches under AD).
        def planner_stage_cost(xc, u, t, theta, goal_X, goal_U):
            return cost_model.stage(
                xc, u, t, theta["mpc_weights"], goal_X, goal_U
            )

        def planner_terminal_cost(xc, theta, goal_X, goal_U):
            del goal_X, goal_U
            return cost_model.terminal(
                xc, theta["cost_params"], theta["mpc_weights"]
            )

        def planner_dynamics(xc, u, t, theta):
            return dynamics_model(xc, u, t, theta["dynamics_params"])

        self._plan = make_implicit_planner(
            planner_stage_cost,
            planner_dynamics,
            settings,
            terminal_cost=planner_terminal_cost,
            solver=bilevel_solver,
            ridge=bilevel_ridge,
        )

    # -- parameter initialization ---------------------------------------

    def init(
        self,
        key: jax.Array,
        mpc_weights,
        u_size: int,
        expert_params=None,
        critic_x_size: Optional[int] = None,
    ) -> dict:
        """Initialize the composite parameter dict
        (cf. ``/root/reference/policy/eval.py:56-62``). A pretrained
        ``expert_params`` pytree is normally passed in (the reference loads
        it from disk); if None, fresh parameters are initialized."""
        kc, kd, ke, kq = jax.random.split(key, 4)
        xc_size = self.x_size + self.dynamics_model.carry_size
        params = {
            "mpc_weights": jnp.asarray(mpc_weights, dtype=jnp.float32),
            "cost_params": self.cost_model.init(kc, xc_size),
            "dynamics_params": self.dynamics_model.init(kd, u_size),
            "expert_params": (
                expert_params
                if expert_params is not None
                else self.expert_model.init_params(ke)
            ),
        }
        if self.critic_model is not None:
            params["critic_params"] = self.critic_model.init_params(
                kq, critic_x_size or self.x_size
            )
        return params

    # -- planning --------------------------------------------------------

    def _theta(self, params: dict) -> dict:
        return {
            "mpc_weights": params["mpc_weights"],
            "cost_params": params["cost_params"],
            "dynamics_params": params["dynamics_params"],
        }

    def goals_and_warm_start(self, params, history_x):
        """Expert-predicted goal states + warm-start actions
        (``/root/reference/policy/eval.py:88-107``)."""
        carry = self.expert_model.warm_carry(
            params["expert_params"], history_x
        )
        return self.expert_model.generate(
            params["expert_params"], carry, self.horizon
        )

    def project_goals(self, dynamics_params, xc0, goal_xseq, init_useq):
        """Project expert-predicted goals onto the learned dynamics'
        REACHABLE manifold (framework extension; no reference
        counterpart).

        Under domain shift the expert's states can be dynamically
        infeasible for the imitator's body (measured on cheetah with 3x
        torso mass: goal-tracking then tops out near the expert's own
        degraded score — BENCHMARKS.md). This pre-pass greedily tracks
        the goals THROUGH the learned (shifted) dynamics: per step, a few
        damped Gauss-Newton iterations find the action whose predicted
        next state is closest to the goal, the state advances through the
        model, and the reachable states replace the goals. The returned
        action sequence (which already tracks the projected goals)
        replaces the expert warm start. Differentiable; O(H x
        goal_projection) extra dynamics evaluations per plan."""
        dyn, xs = self.dynamics_model, self.x_size
        u_dim = init_useq.shape[-1]
        eye = 1e-6 * jnp.eye(u_dim, dtype=jnp.float32)

        def step(xc, inp):
            g_next, u0 = inp

            def resid(u):
                return dyn(xc, u, 0, dynamics_params)[:xs] - g_next

            u = u0
            for _ in range(self.goal_projection):
                r = resid(u)
                J = jax.jacfwd(resid)(u)  # (x, u)
                u = u - jnp.linalg.solve(J.T @ J + eye, J.T @ r)
            u = jnp.clip(u, -1.0, 1.0)
            xc_next = dyn(xc, u, 0, dynamics_params)
            return xc_next, (xc_next[:xs], u)

        _, (G, U) = jax.lax.scan(step, xc0, (goal_xseq[1:], init_useq))
        return jnp.concatenate([goal_xseq[:1], G], axis=0), U

    def plan(
        self,
        params: dict,
        history_x: jax.Array,
        history_u: jax.Array,
        warm_start_carry: bool = True,
    ) -> ILQRSolution:
        """Solve the MPC problem from an observed (normalized) history.

        history_x: (history + 1, x), most recent last; history_u:
        (history, u). Differentiable in params via the implicit VJP.
        """
        goal_xseq, init_useq = self.goals_and_warm_start(params, history_x)
        # The ACTION-goal target is always the predictor's cloned actions
        # (the BC signal that survives domain shift — BENCHMARKS.md ureg
        # sweep); goal projection below is a STATE-goal/warm-start
        # treatment and must not rewrite it.
        u_goal = init_useq
        if warm_start_carry:
            carry = self.dynamics_model.warm_carry(
                params["dynamics_params"], history_x[:-1], history_u
            )
        else:
            carry = self.dynamics_model.zero_carry()
        xc0 = jnp.concatenate([history_x[-1], carry], axis=-1)
        if self.goal_projection > 0:
            goal_xseq, init_useq = self.project_goals(
                params["dynamics_params"], xc0, goal_xseq, init_useq
            )
        return self._plan(
            self._theta(params), xc0, init_useq, (goal_xseq, u_goal), ()
        )

    def act(self, params, history_x, history_u) -> jax.Array:
        """First optimal action — the per-env-step inference hot path
        (``/root/reference/policy/eval.py:126-128``)."""
        return self.plan(params, history_x, history_u).U[0]

    # -- batch-native planning (fused hot path) ---------------------------

    @property
    def batch_native(self) -> bool:
        """Whether the batch-major fused planner path applies (carry-free
        MLP dynamics; recurrent dynamics fall back to vmapped planning)."""
        return self.dynamics_model.is_batch_native

    def plan_batch(self, params, history_X, history_U) -> ILQRSolution:
        """Solve a whole (B,)-batch of MPC problems in ONE solver:
        batch-major iLQR whose cost/dynamics callbacks receive the full
        batch, so the fused MLP ops run on real batches
        (``planner/batch_ilqr.py``). history_X: (B, h+1, x);
        history_U: (B, h, u). Eval semantics (history-warmed; carry-free
        nets have no carry to warm).
        """
        from gan_mpc_tpu.planner.batch_ilqr import BatchProblem, batch_ilqr

        if not self.batch_native:
            sol = jax.vmap(
                lambda hx, hu: self.plan(params, hx, hu)
            )(history_X, history_U)
            return sol

        goal_X, init_U = jax.vmap(
            lambda hx: self.goals_and_warm_start(params, hx)
        )(history_X)
        U_goal = init_U  # action-goal target: cloned actions, pre-projection
        if self.goal_projection > 0:
            goal_X, init_U = jax.vmap(
                lambda x0, g, u: self.project_goals(
                    params["dynamics_params"], x0, g, u
                )
            )(history_X[:, -1], goal_X, init_U)
        goal_tm = jnp.swapaxes(goal_X, 0, 1)  # (T+1, B, x) time-major
        theta_c, theta_w = params["cost_params"], params["mpc_weights"]
        theta_d = params["dynamics_params"]
        cost_model, dyn_model = self.cost_model, self.dynamics_model

        # bf16 path for the dynamics-net GEMMs (line-search rollouts
        # + Jacobian chain) when the solver asks for it; everything the
        # Riccati recursion consumes stays f32 (accumulation is f32).
        cdt = (
            jnp.bfloat16
            if self.settings.compute_dtype == "bfloat16"
            else None
        )

        def dynamics_step(X, U, t):
            del t
            B, K, n = X.shape
            nx = dyn_model.batch_apply(
                theta_d, X.reshape(B * K, n), U.reshape(B * K, -1), cdt
            )
            return nx.reshape(B, K, n)

        def dynamics_jac(X, U):  # time-major (T, B, ...)
            T, B, n = X.shape
            _, A, Bm = dyn_model.batch_value_and_jac(
                theta_d, X.reshape(T * B, n), U.reshape(T * B, -1), cdt
            )
            return (
                A.reshape(T, B, n, n),
                Bm.reshape(T, B, n, -1),
            )

        goal_u_tm = jnp.swapaxes(U_goal, 0, 1)  # (T, B, u) time-major

        problem = BatchProblem(
            dynamics_step=dynamics_step,
            dynamics_jac=dynamics_jac,
            stage_cost=lambda X, U, t: cost_model.stage_cost_batch(
                X, U, t, theta_w, goal_tm, goal_u_tm
            ),
            terminal_cost=lambda X: cost_model.terminal_cost_batch(
                X, theta_c, theta_w
            ),
            quad=lambda X, U: cost_model.quad_batch(
                X, U, theta_c, theta_w, goal_tm, goal_u_tm
            ),
        )
        return batch_ilqr(
            problem, history_X[:, -1], init_U, self.settings
        )

    def act_batch(self, params, history_X, history_U) -> jax.Array:
        """(B,) first optimal actions via the batch-native planner."""
        return self.plan_batch(params, history_X, history_U).U[:, 0]

    def planned_states(self, sol: ILQRSolution) -> jax.Array:
        """Strip the packed dynamics carry: (horizon + 1, x_size)."""
        return sol.X[:, : self.x_size]

    # -- training --------------------------------------------------------

    def batched_loss_and_grad(
        self,
        params: dict,
        history_X: jax.Array,
        loss_fn: Callable,
        loss_args: tuple = (),
        loss_vmap_axes: tuple = (0,),
    ):
        """Mean loss and mean grads of a planner-outer loss over a batch of
        histories. ``loss_fn(policy, sol, params, *args) -> scalar``.

        history_X: (batch, history + 1, x). Equivalent to the reference's
        ``BaseMPC.loss_and_grad`` (``policy/base.py:87-128``) with the
        train-time zero dynamics carry.
        """

        def single(history_x, params, *args):
            zeros_u = jnp.zeros(
                (history_x.shape[0] - 1, self.expert_model.u_size),
                jnp.float32,
            )
            sol = self.plan(
                params, history_x, zeros_u, warm_start_carry=False
            )
            return loss_fn(self, sol, params, *args)

        def batch_loss(params):
            losses = jax.vmap(
                lambda hx, *a: single(hx, params, *a),
                in_axes=(0,) + loss_vmap_axes[: len(loss_args)],
            )(history_X, *loss_args)
            return jnp.mean(losses)

        return jax.value_and_grad(batch_loss)(params)

