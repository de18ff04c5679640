"""Single-instance iLQR trajectory optimizer.

Replaces the reference's external ``trajax.optimizers.ilqr`` dependency
(used at ``/root/reference/policy/optimizers.py:10-21`` with the solver
knobs of ``/root/reference/policy/eval.py:10-20``) with an in-repo,
fully-jitted implementation:

  * the nonlinear rollout is a ``lax.scan``;
  * dynamics linearization and cost quadratization are ``vmap`` +
    ``jacfwd``/``hessian`` over the whole horizon at once (time-batched
    matrix work), not a Python loop;
  * the backward Riccati recursion is a ``lax.scan`` with
    Levenberg-Marquardt regularization of ``Quu``;
  * the line search evaluates a FIXED, static grid of step sizes in
    parallel via ``vmap`` (fixed shapes — no data-dependent trip counts);
  * the outer iteration is a ``lax.while_loop`` whose carry is fixed-shape,
    so the solver vmaps cleanly over thousands of planner instances.

Conventions:
  ``cost(x, u, t)``     scalar; ``t`` runs 0..T, with ``t == T`` the
                        terminal step (``u`` is a zero row there);
  ``dynamics(x, u, t)`` next state, for ``t`` in 0..T-1.

All math is float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp

from gan_mpc_tpu.planner.linalg import solve_spd
from gan_mpc_tpu.utils import struct


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static iLQR knobs (hashable -> usable as a jit static arg).

    Defaults mirror the reference's trajax configuration
    (``/root/reference/policy/eval.py:10-20``): maxiter=100,
    grad_norm_threshold=1e-4, alpha_0=1.0, alpha_min=5e-5.
    """

    max_iterations: int = 100
    grad_norm_tol: float = 1e-4
    obj_step_tol: float = 0.0
    alpha_0: float = 1.0
    alpha_decay: float = 0.5
    num_alphas: int = 16  # alpha_0 * decay**15 ~ 3e-5 <= trajax alpha_min
    reg_init: float = 1e-6
    reg_min: float = 1e-6
    reg_max: float = 1e8
    reg_up: float = 10.0
    reg_down: float = 0.5
    psd_delta: float = 0.0
    # "sequential" scan or "associative" (parallel-in-time, O(log T)
    # depth — for long horizons; see planner/parallel_riccati.py).
    riccati: str = "sequential"
    # Unroll factor for the inner length-T scans (rollout, Riccati,
    # adjoint). At the short horizons MPC uses (T <= 8) full unrolling
    # removes loop overhead and lets XLA overlap timesteps; keep 1 for
    # long horizons to bound compile time.
    inner_unroll: int = 1
    # Line-search winner strategy for the batch solver: "recompute" rolls
    # the winning trajectory once more (no candidate materialization —
    # right for huge B*A blocks), "materialize" emits all candidates from
    # the line-search scan and gathers the winner (elides one length-T
    # scan per iteration — right for long horizons), "auto" picks
    # materialize when T >= 16 and the candidate block is < 32 MB.
    ls_materialize: str = "auto"
    # GEMM compute dtype for the batch solver's dynamics-net evaluations
    # (line-search rollouts + Jacobian-chain GEMMs): "float32" or
    # "bfloat16". bfloat16 runs the matmuls at the bf16 rate with f32
    # accumulation (preferred_element_type); the Riccati recursion, cost
    # quadratization, and all solver state stay f32.
    compute_dtype: str = "float32"


class ILQRSolution(struct.PyTreeNode):
    X: jax.Array  # (T+1, n) optimized state trajectory
    U: jax.Array  # (T, m) optimized controls
    obj: jax.Array  # scalar objective at (X, U)
    grad: jax.Array  # (T, m) dJ/dU at the solution
    adjoints: jax.Array  # (T+1, n) costate trajectory (V_x along solution)
    iterations: jax.Array  # int32 number of outer iterations used
    converged: jax.Array  # bool


def rollout(
    dynamics: Callable, U: jax.Array, x0: jax.Array, unroll: int = 1
) -> jax.Array:
    """Roll controls through dynamics. Returns X with shape (T+1, n)."""

    ts = jnp.arange(U.shape[0])

    def step(x, ut):
        u, t = ut
        nx = dynamics(x, u, t)
        return nx, nx

    _, tail = jax.lax.scan(step, x0, (U, ts), unroll=unroll)
    return jnp.concatenate([x0[None], tail], axis=0)


def _padded(U: jax.Array) -> jax.Array:
    """Controls padded with a zero terminal row -> shape (T+1, m)."""
    return jnp.concatenate([U, jnp.zeros_like(U[-1:])], axis=0)


def total_cost(cost: Callable, X: jax.Array, U: jax.Array) -> jax.Array:
    """Sum of per-step costs incl. terminal (t == T with zero control)."""
    T1 = X.shape[0]
    ts = jnp.arange(T1)
    return jnp.sum(jax.vmap(cost)(X, _padded(U), ts))


def _make_total_fn(cost, terminal_cost):
    """Objective evaluator. With a separate ``terminal_cost`` the stage
    cost is only evaluated for t < T and the terminal only once — vs the
    combined ``jnp.where(t == T, ...)`` form, which evaluates BOTH
    branches (e.g. the terminal cost NN) at every step under jit/AD."""
    if terminal_cost is None:
        return lambda X, U: total_cost(cost, X, U)

    def total(X, U):
        ts = jnp.arange(U.shape[0])
        stage = jnp.sum(jax.vmap(cost)(X[:-1], U, ts))
        return stage + terminal_cost(X[-1])

    return total


def _linearize(dynamics, X, U):
    ts = jnp.arange(U.shape[0])
    jac = jax.vmap(jax.jacfwd(dynamics, argnums=(0, 1)))
    return jac(X[:-1], U, ts)  # A: (T, n, n), B: (T, n, m)


def _quadratize(cost, X, U):
    T1 = X.shape[0]
    ts = jnp.arange(T1)
    Up = _padded(U)
    grads = jax.vmap(jax.grad(cost, argnums=(0, 1)))
    cx, cu = grads(X, Up, ts)

    def hess(x, u, t):
        cxx = jax.hessian(cost, argnums=0)(x, u, t)
        cuu = jax.hessian(cost, argnums=1)(x, u, t)
        cux = jax.jacfwd(jax.grad(cost, argnums=1), argnums=0)(x, u, t)
        return cxx, cuu, cux

    cxx, cuu, cux = jax.vmap(hess)(X, Up, ts)
    return cx, cu, cxx, cuu, cux


def _quadratize_split(cost, terminal_cost, X, U):
    """Quadratize with separate stage / terminal costs: stage derivatives
    vmapped over t < T, terminal (the expensive learned-cost net) exactly
    once."""
    T = U.shape[0]
    ts = jnp.arange(T)
    grads = jax.vmap(jax.grad(cost, argnums=(0, 1)))
    cx_s, cu_s = grads(X[:-1], U, ts)

    def hess(x, u, t):
        cxx = jax.hessian(cost, argnums=0)(x, u, t)
        cuu = jax.hessian(cost, argnums=1)(x, u, t)
        cux = jax.jacfwd(jax.grad(cost, argnums=1), argnums=0)(x, u, t)
        return cxx, cuu, cux

    cxx_s, cuu_s, cux_s = jax.vmap(hess)(X[:-1], U, ts)
    cx_T = jax.grad(terminal_cost)(X[-1])
    cxx_T = jax.hessian(terminal_cost)(X[-1])
    m = U.shape[-1]
    cx = jnp.concatenate([cx_s, cx_T[None]], axis=0)
    cu = jnp.concatenate([cu_s, jnp.zeros((1, m), cu_s.dtype)], axis=0)
    cxx = jnp.concatenate([cxx_s, cxx_T[None]], axis=0)
    cuu = jnp.concatenate(
        [cuu_s, jnp.zeros((1, m, m), cuu_s.dtype)], axis=0
    )
    cux = jnp.concatenate(
        [cux_s, jnp.zeros((1, m, cx_s.shape[-1]), cux_s.dtype)], axis=0
    )
    return cx, cu, cxx, cuu, cux


def _project_psd(mat: jax.Array, delta: float) -> jax.Array:
    """Clamp eigenvalues of a symmetric matrix to >= delta."""
    w, v = jnp.linalg.eigh((mat + mat.T) / 2.0)
    w = jnp.maximum(w, delta)
    return (v * w) @ v.T


def _backward_pass(A, B, cx, cu, cxx, cuu, cux, reg, settings):
    """Riccati recursion -> gains (k, K), expected improvement terms."""

    n = cx.shape[-1]
    Vx, Vxx = cx[-1], cxx[-1]

    def step(carry, inputs):
        Vx, Vxx, dv1, dv2 = carry
        At, Bt, cxt, cut, cxxt, cuut, cuxt = inputs
        Qx = cxt + At.T @ Vx
        Qu = cut + Bt.T @ Vx
        Qxx = cxxt + At.T @ Vxx @ At
        Quu = cuut + Bt.T @ Vxx @ Bt
        Qux = cuxt + Bt.T @ Vxx @ At
        if settings.psd_delta > 0.0:
            Quu_safe = _project_psd(Quu, settings.psd_delta)
        else:
            Quu_safe = Quu
        Quu_reg = Quu_safe + reg * jnp.eye(Quu.shape[0], dtype=Quu.dtype)
        # One solve serves both the open-loop and feedback gains. Unrolled
        # Gauss-Jordan for these tiny SPD systems: no LU/cholesky custom
        # call (which fails to register inside large fused XLA:CPU
        # modules) — see planner/linalg.py.
        kK = solve_spd(
            Quu_reg, jnp.concatenate([Qu[:, None], Qux], axis=1)
        )
        k, K = -kK[:, 0], -kK[:, 1:]
        Vx_new = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        Vxx_new = Qxx + K.T @ Quu @ K + K.T @ Qux + Qux.T @ K
        Vxx_new = (Vxx_new + Vxx_new.T) / 2.0
        dv1 = dv1 + jnp.dot(k, Qu)
        dv2 = dv2 + 0.5 * jnp.dot(k, Quu @ k)
        return (Vx_new, Vxx_new, dv1, dv2), (k, K, Qu, Vx_new)

    inputs = (A, B, cx[:-1], cu[:-1], cxx[:-1], cuu[:-1], cux[:-1])
    (_, _, dv1, dv2), (k, K, Qu, Vxs) = jax.lax.scan(
        step, (Vx, Vxx, 0.0, 0.0), inputs, reverse=True,
        unroll=settings.inner_unroll,
    )
    adjoints = jnp.concatenate([Vxs, cx[-1][None]], axis=0)
    return k, K, Qu, dv1, dv2, adjoints


def _adjoint_gradient(A, B, cx, cu, unroll: int = 1):
    """Exact open-loop objective gradient dJ/dU at the CURRENT (X, U) via
    the costate (adjoint) recursion over the already-computed linearization:

        lam_T = cx_T;  g_t = cu_t + B_t^T lam_{t+1};
        lam_t = cx_t + A_t^T lam_{t+1}.

    O(T) matvecs on (n,)-vectors — replaces a full reverse-mode AD pass
    through the rollout (which re-runs every dynamics/cost backward) per
    iLQR iteration. This is the same gradient trajax derives from its
    backward pass (``/root/reference/policy/optimizers.py:55-57`` unpacks
    it as ``gradient``)."""

    def step(lam, inputs):
        At, Bt, cxt, cut = inputs
        g = cut + Bt.T @ lam
        lam_new = cxt + At.T @ lam
        return lam_new, g

    _, G = jax.lax.scan(
        step, cx[-1], (A, B, cx[:-1], cu[:-1]), reverse=True, unroll=unroll
    )
    return G


def _forward_pass(dynamics, total_fn, X, U, k, K, alpha, unroll: int = 1):
    """Closed-loop rollout with step size alpha. Returns (Xnew, Unew, obj)."""

    ts = jnp.arange(U.shape[0])

    def step(x, inputs):
        xref, uref, kt, Kt, t = inputs
        u = uref + alpha * kt + Kt @ (x - xref)
        nx = dynamics(x, u, t)
        return nx, (nx, u)

    _, (tail, Unew) = jax.lax.scan(
        step, X[0], (X[:-1], U, k, K, ts), unroll=unroll
    )
    Xnew = jnp.concatenate([X[0][None], tail], axis=0)
    return Xnew, Unew, total_fn(Xnew, Unew)


def _objective_grad(total_fn, dynamics, U, x0):
    def f(U_):
        return total_fn(rollout(dynamics, U_, x0), U_)

    return jax.grad(f)(U)


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 5))
def ilqr(
    cost: Callable,
    dynamics: Callable,
    x0: jax.Array,
    U0: jax.Array,
    settings: SolverSettings = SolverSettings(),
    terminal_cost: Callable = None,
) -> ILQRSolution:
    """Iterative LQR solve. Matches the reference planner contract
    (X, U, obj, grad, adjoints, iterations) of
    ``/root/reference/policy/optimizers.py:55-57`` as a typed struct.

    ``cost(x, u, t)`` covers every step when ``terminal_cost`` is None
    (t == T selects the terminal, trajax-style). With ``terminal_cost(x)``
    given, ``cost`` is the STAGE cost only (t < T) — substantially cheaper
    when the terminal involves a neural net, since the combined form
    evaluates both branches of its jnp.where at every step under AD."""

    x0 = x0.astype(jnp.float32)
    U0 = U0.astype(jnp.float32)
    T, m = U0.shape
    total_fn = _make_total_fn(cost, terminal_cost)

    alphas = settings.alpha_0 * (
        settings.alpha_decay ** jnp.arange(settings.num_alphas, dtype=jnp.float32)
    )

    X0 = rollout(dynamics, U0, x0, unroll=settings.inner_unroll)
    obj0 = total_fn(X0, U0)
    grad0 = _objective_grad(total_fn, dynamics, U0, x0)
    adj0 = jnp.zeros_like(X0)

    def cond(carry):
        _, _, _, grad, _, _, it, converged = carry
        return jnp.logical_and(it < settings.max_iterations, ~converged)

    def body(carry):
        X, U, obj, grad, adj, reg, it, _ = carry
        A, B = _linearize(dynamics, X, U)
        if terminal_cost is None:
            cx, cu, cxx, cuu, cux = _quadratize(cost, X, U)
        else:
            cx, cu, cxx, cuu, cux = _quadratize_split(
                cost, terminal_cost, X, U
            )
        if settings.riccati == "associative":
            from gan_mpc_tpu.planner.parallel_riccati import (
                parallel_backward_pass,
            )

            k, K, Qu, dv1, dv2, adjoints = parallel_backward_pass(
                A, B, cx, cu, cxx, cuu, cux, reg, settings.psd_delta
            )
        else:
            k, K, Qu, dv1, dv2, adjoints = _backward_pass(
                A, B, cx, cu, cxx, cuu, cux, reg, settings
            )

        # Exact gradient at the current iterate from the linearization
        # already in hand — no extra reverse-AD pass (see _adjoint_gradient).
        gradn = _adjoint_gradient(
            A, B, cx, cu, unroll=settings.inner_unroll
        )

        # Parallel fixed-grid line search (static shapes, one vmap).
        Xs, Us, objs = jax.vmap(
            lambda a: _forward_pass(
                dynamics, total_fn, X, U, k, K, a,
                unroll=settings.inner_unroll,
            )
        )(alphas)
        objs = jnp.where(jnp.isfinite(objs), objs, jnp.inf)
        best = jnp.argmin(objs)
        best_obj = objs[best]
        improved = best_obj < obj

        Xn = jnp.where(improved, Xs[best], X)
        Un = jnp.where(improved, Us[best], U)
        objn = jnp.where(improved, best_obj, obj)
        regn = jnp.where(
            improved,
            jnp.maximum(reg * settings.reg_down, settings.reg_min),
            jnp.minimum(reg * settings.reg_up, settings.reg_max),
        )
        adjn = jnp.where(improved, adjoints, adj)

        grad_small = jnp.linalg.norm(gradn) < settings.grad_norm_tol
        stalled = jnp.logical_and(~improved, reg >= settings.reg_max)
        converged = grad_small | stalled
        if settings.obj_step_tol > 0.0:
            step_small = jnp.logical_and(
                improved, (obj - objn) <= settings.obj_step_tol
            )
            converged = converged | step_small
        return (Xn, Un, objn, gradn, adjn, regn, it + 1, converged)

    init = (
        X0,
        U0,
        obj0,
        grad0,
        adj0,
        jnp.float32(settings.reg_init),
        jnp.int32(0),
        jnp.linalg.norm(grad0) < settings.grad_norm_tol,
    )
    X, U, obj, grad, adj, _, it, converged = jax.lax.while_loop(
        cond, body, init
    )
    return ILQRSolution(
        X=X,
        U=U,
        obj=obj,
        grad=grad,
        adjoints=adj,
        iterations=it,
        converged=converged,
    )
