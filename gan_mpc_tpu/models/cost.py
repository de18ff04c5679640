"""Learned cost model.

Capability parity with the reference cost stack
(``/root/reference/cost/nn.py`` + ``/root/reference/cost/cost_model.py``):

  * a feature MLP whose squared feature norm is the (always >= 0) learned
    terminal cost;
  * a running cost that is a sigmoid-weighted combination of smoothed-L1
    ("pseudo-Huber", alpha = 1e-2) action magnitude and distance to a
    per-timestep goal state;
  * the terminal step (``t == horizon``) selects the NN cost scaled by the
    (sigmoid-squashed) terminal weight.

The trainable pieces are the MLP parameters and the three raw MPC weights
(action, state, terminal) — both flow gradients through the planner via the
implicit bilevel VJP.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from gan_mpc_tpu.models.layers import mlp, mlp_init

_HUBER_ALPHA = 1e-2


def smoothed_norm(v: jax.Array, alpha: float = _HUBER_ALPHA) -> jax.Array:
    """Pseudo-Huber magnitude: sqrt(|v|^2 + a^2) - a (smooth at 0)."""
    return jnp.sqrt(jnp.vdot(v, v) + alpha * alpha) - alpha


@dataclasses.dataclass(frozen=True)
class CostFeatureNet:
    """MLP mapping the planner state to a feature vector f; cost = <f, f>."""

    hidden: Sequence[int] = (128, 128)
    features_out: int = 10

    def init(self, key: jax.Array, xc: jax.Array) -> dict:
        widths = (*self.hidden, self.features_out)
        return {"params": mlp_init(key, xc.shape[-1], widths)}

    def apply(self, params, xc: jax.Array) -> jax.Array:
        f = mlp(params["params"], xc, len(self.hidden) + 1)
        return jnp.vdot(f, f)


class MPCCost:
    """Stateless planner-cost assembler around a CostFeatureNet.

    ``params`` convention: ``{"net": <CostFeatureNet params>, "weights":
    (3,) raw}``
    where ``weights`` are pre-sigmoid (action, state, terminal) — or
    (4,) with a trailing action-GOAL weight, see ``stage``.
    """

    def __init__(
        self,
        net: CostFeatureNet,
        horizon: int,
        action_goal_scale: float = 1.0,
        action_goal_squared: bool = False,
    ):
        self.net = net
        self.horizon = horizon
        # Action-goal term shaping (framework extension, no reference
        # counterpart). The sigmoid-squashed weight caps at 1.0, but the
        # regime that wins under domain shift is lam*|u - u_pred|^2 with
        # lam ~ 5-50 (BENCHMARKS.md cheetah ureg sweep) — far outside
        # what a <=1 pseudo-Huber term can express. `scale` multiplies
        # the term; `squared` switches pseudo-Huber -> squared error to
        # match the measured-winning objective exactly.
        self.action_goal_scale = float(action_goal_scale)
        self.action_goal_squared = bool(action_goal_squared)

    def _action_goal_cost(self, du: jax.Array) -> jax.Array:
        """Scalar action-goal penalty for a single du (last-dim vector)."""
        if self.action_goal_squared:
            return self.action_goal_scale * jnp.vdot(du, du)
        return self.action_goal_scale * smoothed_norm(du)

    def init(self, key: jax.Array, xc_size: int) -> dict:
        net_params = self.net.init(key, jnp.zeros((xc_size,)))
        return net_params

    def stage(
        self,
        xc: jax.Array,
        u: jax.Array,
        t: jax.Array,
        raw_weights: jax.Array,
        goal_X: jax.Array,
        goal_U: jax.Array | None = None,
    ) -> jax.Array:
        """Running cost for t < horizon (no neural net involved).

        With a 4th raw weight and ``goal_U``, an ACTION-goal term
        w3 * huber(u - goal_U[t]) joins the objective (framework
        extension; no reference counterpart). Rationale: under domain
        shift the expert's cloned ACTIONS carry information the state
        goals cannot express — measured on cheetah x3 torso mass, pure
        state tracking through the TRUE shifted physics returns 16.6
        while executing the predictor's cloned actions returns 27.9
        (BENCHMARKS.md round 3). The weight is sigmoid-squashed and
        trained adversarially like the others, so the critic tunes how
        much to trust actions vs states.

        A 5th raw weight is the action-goal GAIN alpha (NOT squashed,
        init 1.0): the tracked target becomes alpha * goal_U[t]. Under
        domain shift the demonstrated torque AMPLITUDE can be wrong for
        the new body (x3-mass cheetah wants ~1.5x the gait torques —
        BENCHMARKS.md amplitude scan); alpha lets the adversarial critic
        rescale the cloned actions, since faster planned states read as
        more expert-like."""
        w = jax.nn.sigmoid(raw_weights)
        x_size = goal_X.shape[-1]
        goal = goal_X[t]
        cost = w[0] * smoothed_norm(u) + w[1] * smoothed_norm(
            xc[:x_size] - goal
        )
        if raw_weights.shape[-1] > 3 and goal_U is not None:
            gain = (
                raw_weights[4] if raw_weights.shape[-1] > 4 else 1.0
            )
            cost = cost + w[3] * self._action_goal_cost(
                u - gain * goal_U[t]
            )
        return cost

    def terminal(
        self, xc: jax.Array, net_params, raw_weights: jax.Array
    ) -> jax.Array:
        """Terminal cost: sigmoid(w_term) * <f(x), f(x)>."""
        w = jax.nn.sigmoid(raw_weights)
        return w[2] * self.net.apply(net_params, xc)

    # -- batch-native planner hooks --------------------------------------
    #
    # The stage cost is closed-form (pseudo-Huber in u and in x - goal,
    # separable => cux = 0), and the terminal relu net's Hessian is
    # EXACTLY its Gauss-Newton form 2 w JᵀJ (relu is piecewise-linear, so
    # the residual's second derivative vanishes a.e.) — no AD hessians in
    # the planner's hot loop.

    def stage_cost_batch(self, X, U, t, raw_weights, goal_tm, goal_u_tm=None):
        """X (B,K,n), U (B,K,m), goal_tm (T+1,B,gs) TIME-MAJOR -> (B,K)."""
        w = jax.nn.sigmoid(raw_weights)
        gs = goal_tm.shape[-1]
        d = X[..., :gs] - goal_tm[t][:, None]
        a = _HUBER_ALPHA
        sn = lambda v: jnp.sqrt(jnp.sum(v * v, -1) + a * a) - a
        cost = w[0] * sn(U) + w[1] * sn(d)
        if raw_weights.shape[-1] > 3 and goal_u_tm is not None:
            gain = raw_weights[4] if raw_weights.shape[-1] > 4 else 1.0
            du = U - gain * goal_u_tm[t][:, None]
            if self.action_goal_squared:
                ag = self.action_goal_scale * jnp.sum(du * du, -1)
            else:
                ag = self.action_goal_scale * sn(du)
            cost = cost + w[3] * ag
        return cost

    def terminal_cost_batch(self, X, net_params, raw_weights):
        """X (B,K,n) -> (B,K): w2 * |f(x)|^2 via the fused stack."""
        from gan_mpc_tpu.ops.fused_mlp import dense_stack, mlp_apply

        w = jax.nn.sigmoid(raw_weights)
        B, K, n = X.shape
        f = mlp_apply(X.reshape(B * K, n), dense_stack(net_params))
        return w[2] * jnp.sum(f * f, -1).reshape(B, K)

    def quad_batch(self, X, U, net_params, raw_weights, goal_tm,
                   goal_u_tm=None):
        """Whole-horizon quadratization, TIME-MAJOR: X (T+1,B,n),
        U (T,B,m), goal_tm (T+1,B,gs) -> cx (T+1,B,n), cu (T,B,m),
        cxx (T+1,B,n,n), cuu (T,B,m,m), cux (T,B,m,n) — stage rows
        closed-form, terminal row from the fused value-and-Jacobian of
        the feature net."""
        from gan_mpc_tpu.ops.fused_mlp import dense_stack, mlp_value_and_jac

        w = jax.nn.sigmoid(raw_weights)
        T1, B, n = X.shape
        T = T1 - 1
        m = U.shape[-1]
        a = _HUBER_ALPHA
        gs = goal_tm.shape[-1]
        eye_g = jnp.eye(gs, dtype=X.dtype)
        eye_m = jnp.eye(m, dtype=X.dtype)

        def huber(v, eye):
            s = jnp.sqrt(jnp.sum(v * v, -1, keepdims=True) + a * a)
            g = v / s  # (..., d)
            H = eye / s[..., None] - (
                v[..., :, None] * v[..., None, :]
            ) / (s[..., None] ** 3)
            return g, H

        d = X[:T, :, :gs] - goal_tm[:T]
        gx, Hx = huber(d, eye_g)
        cx_s = jnp.zeros((T, B, n), X.dtype).at[..., :gs].set(w[1] * gx)
        cxx_s = (
            jnp.zeros((T, B, n, n), X.dtype)
            .at[..., :gs, :gs]
            .set(w[1] * Hx)
        )
        gu, Hu = huber(U, eye_m)
        cu = w[0] * gu
        cuu = w[0] * Hu
        if raw_weights.shape[-1] > 3 and goal_u_tm is not None:
            gain = raw_weights[4] if raw_weights.shape[-1] > 4 else 1.0
            du = U - gain * goal_u_tm[:T]
            if self.action_goal_squared:
                gu2 = 2.0 * du
                Hu2 = jnp.broadcast_to(2.0 * eye_m, du.shape[:-1] + (m, m))
            else:
                gu2, Hu2 = huber(du, eye_m)
            s = self.action_goal_scale
            cu = cu + (w[3] * s) * gu2
            cuu = cuu + (w[3] * s) * Hu2
        cux = jnp.zeros((T, B, m, n), X.dtype)

        # terminal: value/grad/hess of w2 |f(x)|^2, exact for relu nets
        f, J = mlp_value_and_jac(X[-1], dense_stack(net_params))
        cx_T = 2.0 * w[2] * jnp.einsum("bo,boi->bi", f, J)
        cxx_T = 2.0 * w[2] * jnp.einsum("boi,boj->bij", J, J)

        cx = jnp.concatenate([cx_s, cx_T[None]], axis=0)
        cxx = jnp.concatenate([cxx_s, cxx_T[None]], axis=0)
        return cx, cu, cxx, cuu, cux

    def __call__(
        self,
        xc: jax.Array,
        u: jax.Array,
        t: jax.Array,
        net_params,
        raw_weights: jax.Array,
        goal_X: jax.Array,
    ) -> jax.Array:
        """Combined planner cost (t == horizon selects the terminal) —
        kept for the trajax-style single-function interface; the policy
        uses the split stage/terminal form for speed."""
        return jnp.where(
            t == self.horizon,
            self.terminal(xc, net_params, raw_weights),
            self.stage(xc, u, t, raw_weights, goal_X),
        )
