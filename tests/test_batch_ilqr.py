"""Batch-native iLQR (planner/batch_ilqr.py) against oracles and the
per-instance solver.

Covers: LQR-oracle exactness of the batch solver, the analytic/fused
quadratization and linearization against AD, batch_apply against the
per-instance net, and whole-solve agreement between ``plan_batch`` and
vmapped ``plan`` on the flagship MPC problem.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ge
from gan_mpc_tpu.planner import SolverSettings
from gan_mpc_tpu.planner.batch_ilqr import BatchProblem, batch_ilqr
from gan_mpc_tpu.planner.linalg import solve_spd

ilqr_mod = importlib.import_module("gan_mpc_tpu.planner.ilqr")

KEY = jax.random.PRNGKey(0)


def _lqr_problem(B, T, n, m, key):
    """Random batched LQR with per-lane dynamics; analytic callbacks."""
    k1, k2, k3 = jax.random.split(key, 3)
    A = jnp.eye(n) + 0.05 * jax.random.normal(k1, (B, n, n))
    Bm = 0.5 * jax.random.normal(k2, (B, n, m))
    Q = jnp.eye(n) * 1.0
    R = jnp.eye(m) * 0.1
    x0 = jax.random.normal(k3, (B, n))

    problem = BatchProblem(
        dynamics_step=lambda X, U, t: (
            jnp.einsum("bij,bkj->bki", A, X)
            + jnp.einsum("bij,bkj->bki", Bm, U)
        ),
        dynamics_jac=lambda X, U: (
            jnp.broadcast_to(A[None], X.shape[:2] + (X.shape[-1],) * 2),
            jnp.broadcast_to(Bm[None], X.shape[:2] + Bm.shape[1:]),
        ),
        stage_cost=lambda X, U, t: 0.5
        * (
            jnp.einsum("bki,ij,bkj->bk", X, Q, X)
            + jnp.einsum("bki,ij,bkj->bk", U, R, U)
        ),
        terminal_cost=lambda X: 0.5 * jnp.einsum("bki,ij,bkj->bk", X, Q, X),
        quad=lambda X, U: (
            jnp.einsum("ij,tbj->tbi", Q, X),
            jnp.einsum("ij,tbj->tbi", R, U),
            jnp.broadcast_to(Q, X.shape[:2] + (X.shape[-1],) * 2),
            jnp.broadcast_to(R, U.shape[:2] + (U.shape[-1],) * 2),
            jnp.zeros(U.shape[:2] + (U.shape[-1], X.shape[-1])),
        ),
    )
    return problem, A, Bm, Q, R, x0


def _lqr_oracle_controls(A, Bm, Q, R, x0, T):
    """Exact finite-horizon LQR controls for one lane via Riccati."""
    P = Q
    Ks = []
    for _ in range(T):
        M = R + Bm.T @ P @ Bm
        K = np.linalg.solve(M, Bm.T @ P @ A)
        P = Q + A.T @ P @ A - A.T @ P @ Bm @ K
        Ks.append(K)
    Ks = Ks[::-1]
    x, us = x0, []
    for t in range(T):
        u = -Ks[t] @ x
        us.append(u)
        x = A @ x + Bm @ u
    return np.stack(us)


def test_batch_ilqr_matches_lqr_oracle():
    B, T, n, m = 4, 6, 3, 2
    problem, A, Bm, Q, R, x0 = _lqr_problem(B, T, n, m, KEY)
    U0 = jnp.zeros((B, T, m))
    sol = batch_ilqr(
        problem, x0, U0, SolverSettings(max_iterations=20, grad_norm_tol=1e-7)
    )
    assert bool(jnp.all(sol.converged))
    for b in range(B):
        U_star = _lqr_oracle_controls(
            np.asarray(A[b]), np.asarray(Bm[b]), np.asarray(Q),
            np.asarray(R), np.asarray(x0[b]), T,
        )
        np.testing.assert_allclose(
            np.asarray(sol.U[b]), U_star, atol=2e-4
        )


def test_batch_ilqr_materialized_line_search_matches_recompute():
    """The materialized-winner strategy (long-horizon path: candidates
    emitted from the line-search scan, winner gathered, recompute scan
    elided) must agree with the recompute strategy on solution controls,
    objective, and convergence — same math, different schedule."""
    B, T, n, m = 3, 20, 3, 2
    problem, A, Bm, Q, R, x0 = _lqr_problem(B, T, n, m, KEY)
    U0 = jnp.zeros((B, T, m))
    base = SolverSettings(max_iterations=25, grad_norm_tol=1e-7)
    sol_r = batch_ilqr(
        problem, x0, U0,
        dataclasses.replace(base, ls_materialize="recompute"),
    )
    sol_m = batch_ilqr(
        problem, x0, U0,
        dataclasses.replace(base, ls_materialize="materialize"),
    )
    assert bool(jnp.all(sol_r.converged)) and bool(jnp.all(sol_m.converged))
    np.testing.assert_allclose(
        np.asarray(sol_m.U), np.asarray(sol_r.U), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sol_m.obj), np.asarray(sol_r.obj), rtol=1e-6
    )
    # T=20 with a tiny candidate block also triggers the auto heuristic
    sol_a = batch_ilqr(problem, x0, U0, base)
    np.testing.assert_allclose(
        np.asarray(sol_a.U), np.asarray(sol_m.U), atol=1e-6
    )


def test_batch_ilqr_associative_riccati_matches_sequential():
    """settings.riccati='associative' (log-depth backward + associative
    costate gradient) must agree with the sequential batch recursion on
    controls, objective, and per-lane convergence."""
    B, T, n, m = 3, 24, 3, 2
    problem, A, Bm, Q, R, x0 = _lqr_problem(B, T, n, m, KEY)
    U0 = jnp.zeros((B, T, m))
    base = SolverSettings(max_iterations=25, grad_norm_tol=1e-6)
    sol_s = batch_ilqr(problem, x0, U0, base)
    sol_a = batch_ilqr(
        problem, x0, U0, dataclasses.replace(base, riccati="associative")
    )
    assert bool(jnp.all(sol_s.converged)) and bool(jnp.all(sol_a.converged))
    np.testing.assert_allclose(
        np.asarray(sol_a.U), np.asarray(sol_s.U), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(sol_a.obj), np.asarray(sol_s.obj), rtol=1e-5
    )
    # the associative costate gradient agrees with the sequential
    # recursion on FIXED inputs (solution.grad snapshots are taken at
    # each variant's own stopping iteration, so they are not comparable)
    from gan_mpc_tpu.planner import batch_ilqr as bi

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(7), 4)
    Af = jnp.eye(n) + 0.1 * jax.random.normal(k1, (T, B, n, n))
    Bf = jax.random.normal(k2, (T, B, n, m))
    cxf = jax.random.normal(k3, (T + 1, B, n))
    cuf = jax.random.normal(k4, (T, B, m))
    G_seq = bi._adjoint_gradient(Af, Bf, cxf, cuf)
    eye = jnp.broadcast_to(jnp.eye(n), (T, B, n, n))
    cxxf = eye
    cuuf = jnp.broadcast_to(jnp.eye(m), (T, B, m, m))
    cuxf = jnp.zeros((T, B, m, n))
    *_, G_assoc = bi._backward_associative(
        Af, Bf, cxf, cuf, jnp.concatenate([cxxf, cxxf[:1]]), cuuf, cuxf,
        jnp.zeros(B), SolverSettings(),
    )
    np.testing.assert_allclose(
        np.asarray(G_assoc), np.asarray(G_seq), rtol=2e-5, atol=2e-5
    )


def test_batch_ilqr_lanes_converge_independently():
    B, T, n, m = 6, 5, 3, 2
    problem, A, Bm, Q, R, x0 = _lqr_problem(B, T, n, m, KEY)
    # lane 0 starts AT the optimum-ish (tiny state), others far away
    x0 = x0.at[0].set(1e-6 * x0[0])
    sol = batch_ilqr(
        problem, x0, jnp.zeros((B, T, m)),
        SolverSettings(max_iterations=20, grad_norm_tol=1e-6),
    )
    assert bool(jnp.all(sol.converged))
    assert int(sol.iterations[0]) <= 2
    # per-lane iteration counts are genuinely independent
    assert int(jnp.max(sol.iterations)) >= int(sol.iterations[0])


@pytest.fixture(scope="module")
def flagship():
    policy, params, x_size, u_size = ge._flagship(
        horizon=5, max_iterations=5, x_size=17, u_size=6
    )
    return policy, params, x_size, u_size


def test_quad_batch_matches_ad(flagship):
    policy, params, x_size, u_size = flagship
    B, T = 4, policy.horizon
    k1, k2, k3 = jax.random.split(KEY, 3)
    X = 0.3 * jax.random.normal(k1, (T + 1, B, x_size))
    U = 0.3 * jax.random.normal(k2, (T, B, u_size))
    goal_tm = 0.3 * jax.random.normal(k3, (T + 1, B, x_size))
    theta_w = params["mpc_weights"]
    theta_c = params["cost_params"]

    an = policy.cost_model.quad_batch(X, U, theta_c, theta_w, goal_tm)

    stage = lambda x, u, t, g: policy.cost_model.stage(x, u, t, theta_w, g)
    term = lambda x: policy.cost_model.terminal(x, theta_c, theta_w)
    Xb = jnp.swapaxes(X, 0, 1)
    Ub = jnp.swapaxes(U, 0, 1)
    ad = jax.vmap(
        lambda X_, U_, g: ilqr_mod._quadratize_split(
            lambda x, u, t: stage(x, u, t, g), term, X_, U_
        )
    )(Xb, Ub, jnp.swapaxes(goal_tm, 0, 1))
    for name, a_, b_ in zip(["cx", "cu", "cxx", "cuu", "cux"], ad, an):
        b_bm = jnp.swapaxes(b_, 0, 1)
        a_ = a_[:, : b_bm.shape[1]]  # AD pads cu/cuu/cux with terminal row
        np.testing.assert_allclose(
            np.asarray(a_), np.asarray(b_bm), atol=2e-3, err_msg=name
        )


def test_quad_batch_matches_ad_with_action_goal(flagship):
    """Closed-form quadratization of the optional 4th-weight action-goal
    term w3*huber(u - u_pred) matches autodiff."""
    policy, params, x_size, u_size = flagship
    B, T = 3, policy.horizon
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    X = 0.3 * jax.random.normal(k1, (T + 1, B, x_size))
    U = 0.3 * jax.random.normal(k2, (T, B, u_size))
    goal_tm = 0.3 * jax.random.normal(k3, (T + 1, B, x_size))
    goal_u_tm = 0.3 * jax.random.normal(k4, (T, B, u_size))
    theta_w = jnp.concatenate(
        [params["mpc_weights"], jnp.array([0.7])]
    )  # 4 weights
    theta_c = params["cost_params"]

    an = policy.cost_model.quad_batch(
        X, U, theta_c, theta_w, goal_tm, goal_u_tm
    )
    stage = lambda x, u, t, g, gu: policy.cost_model.stage(
        x, u, t, theta_w, g, gu
    )
    term = lambda x: policy.cost_model.terminal(x, theta_c, theta_w)
    Xb, Ub = jnp.swapaxes(X, 0, 1), jnp.swapaxes(U, 0, 1)
    ad = jax.vmap(
        lambda X_, U_, g, gu: ilqr_mod._quadratize_split(
            lambda x, u, t: stage(x, u, t, g, gu), term, X_, U_
        )
    )(Xb, Ub, jnp.swapaxes(goal_tm, 0, 1), jnp.swapaxes(goal_u_tm, 0, 1))
    for name, a_, b_ in zip(["cx", "cu", "cxx", "cuu", "cux"], ad, an):
        b_bm = jnp.swapaxes(b_, 0, 1)
        a_ = a_[:, : b_bm.shape[1]]
        np.testing.assert_allclose(
            np.asarray(a_), np.asarray(b_bm), atol=2e-3, err_msg=name
        )


def test_quad_batch_matches_ad_scaled_squared_action_goal(flagship):
    """The scaled/squared action-goal form (action_goal_scale=20,
    action_goal_squared=True — the lam*|u - u_pred|^2 regime measured to
    win under domain shift) quadratizes exactly like autodiff."""
    from gan_mpc_tpu.models import MPCCost

    policy, params, x_size, u_size = flagship
    cost = MPCCost(
        policy.cost_model.net,
        horizon=policy.horizon,
        action_goal_scale=20.0,
        action_goal_squared=True,
    )
    B, T = 3, policy.horizon
    k1, k2, k3, k4 = jax.random.split(KEY, 4)
    X = 0.3 * jax.random.normal(k1, (T + 1, B, x_size))
    U = 0.3 * jax.random.normal(k2, (T, B, u_size))
    goal_tm = 0.3 * jax.random.normal(k3, (T + 1, B, x_size))
    goal_u_tm = 0.3 * jax.random.normal(k4, (T, B, u_size))
    theta_w = jnp.concatenate([params["mpc_weights"], jnp.array([0.7])])
    theta_c = params["cost_params"]

    an = cost.quad_batch(X, U, theta_c, theta_w, goal_tm, goal_u_tm)
    stage = lambda x, u, t, g, gu: cost.stage(x, u, t, theta_w, g, gu)
    term = lambda x: cost.terminal(x, theta_c, theta_w)
    Xb, Ub = jnp.swapaxes(X, 0, 1), jnp.swapaxes(U, 0, 1)
    ad = jax.vmap(
        lambda X_, U_, g, gu: ilqr_mod._quadratize_split(
            lambda x, u, t: stage(x, u, t, g, gu), term, X_, U_
        )
    )(Xb, Ub, jnp.swapaxes(goal_tm, 0, 1), jnp.swapaxes(goal_u_tm, 0, 1))
    for name, a_, b_ in zip(["cx", "cu", "cxx", "cuu", "cux"], ad, an):
        b_bm = jnp.swapaxes(b_, 0, 1)
        a_ = a_[:, : b_bm.shape[1]]
        np.testing.assert_allclose(
            np.asarray(a_), np.asarray(b_bm), atol=2e-2, err_msg=name
        )
    # the batched stage cost agrees with the per-sample scalar stage
    sc = cost.stage_cost_batch(
        X[0][:, None], U[0][:, None], 0, theta_w, goal_tm, goal_u_tm
    )
    ref = jax.vmap(
        lambda x, u, g, gu: cost.stage(x, u, 0, theta_w, g, gu)
    )(X[0], U[0], jnp.swapaxes(goal_tm, 0, 1), jnp.swapaxes(goal_u_tm, 0, 1))
    np.testing.assert_allclose(
        np.asarray(sc[:, 0]), np.asarray(ref), atol=1e-4
    )


def test_batch_jacobian_matches_ad(flagship):
    policy, params, x_size, u_size = flagship
    theta_d = params["dynamics_params"]
    N = 64
    k1, k2 = jax.random.split(KEY)
    X = jax.random.normal(k1, (N, x_size))
    U = jax.random.normal(k2, (N, u_size))
    nx, A, Bm = policy.dynamics_model.batch_value_and_jac(theta_d, X, U)
    np.testing.assert_allclose(
        np.asarray(nx),
        np.asarray(policy.dynamics_model.batch_apply(theta_d, X, U)),
        atol=1e-5,
    )
    dyn = lambda x, u: policy.dynamics_model(x, u, 0, theta_d)
    A_ad, B_ad = jax.vmap(jax.jacfwd(dyn, argnums=(0, 1)))(X, U)
    np.testing.assert_allclose(np.asarray(A), np.asarray(A_ad), atol=1e-5)
    np.testing.assert_allclose(np.asarray(Bm), np.asarray(B_ad), atol=1e-5)


def test_batch_apply_matches_net(flagship):
    policy, params, x_size, u_size = flagship
    theta_d = params["dynamics_params"]
    N = 32
    k1, k2 = jax.random.split(KEY)
    X = jax.random.normal(k1, (N, x_size))
    U = jax.random.normal(k2, (N, u_size))
    got = policy.dynamics_model.batch_apply(theta_d, X, U)
    want = jax.vmap(lambda x, u: policy.dynamics_model(x, u, 0, theta_d))(
        X, U
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_plan_batch_close_to_vmapped_plan(flagship):
    policy, params, x_size, u_size = flagship
    B = 8
    hX = 0.1 * jax.random.normal(KEY, (B, 2, x_size))
    hU = jnp.zeros((B, 1, u_size))
    sol_b = policy.plan_batch(params, hX, hU)
    sol_v = jax.vmap(lambda hx, hu: policy.plan(params, hx, hu))(hX, hU)
    # Same problem, same solver family; line-search rounding may pick a
    # slightly different local iterate, so compare objectives, not exact
    # trajectories.
    np.testing.assert_allclose(
        np.asarray(sol_b.obj), np.asarray(sol_v.obj), rtol=0.05, atol=0.02
    )
    assert sol_b.U.shape == sol_v.U.shape == (B, policy.horizon, u_size)


def test_solve_spd_matches_lu():
    # m <= 8 exercises the unrolled path; m > 8 the rolled fori_loop
    # path (the dense bilevel solve's (T*m)^2 systems — must stay
    # custom-call-free so fused CPU epochs compile, see planner/linalg).
    for m in (1, 2, 4, 6, 8, 10, 24, 60):
        k = jax.random.fold_in(KEY, m)
        A = jax.random.normal(k, (8, m, m))
        A = A @ jnp.swapaxes(A, -1, -2) + 0.1 * jnp.eye(m)
        B = jax.random.normal(jax.random.fold_in(k, 1), (8, m, m + 2))
        np.testing.assert_allclose(
            np.asarray(solve_spd(A, B)),
            np.asarray(jnp.linalg.solve(A, B)),
            atol=5e-3,
        )


def test_solve_spd_rolled_is_differentiable():
    # the dense bilevel IFT solve differentiates through solve_spd when
    # the outer objective depends on theta through A(theta); the rolled
    # path must support reverse mode (fori_loop with static trip count
    # lowers to scan).
    m = 12
    k = jax.random.fold_in(KEY, 99)
    A0 = jax.random.normal(k, (m, m))
    A0 = A0 @ A0.T + 0.5 * jnp.eye(m)
    b = jax.random.normal(jax.random.fold_in(k, 1), (m, 1))

    def f(s):
        return jnp.sum(solve_spd(A0 * s, b))

    g = jax.grad(f)(1.0)
    # d/ds sum((sA)^-1 b) = -sum(A^-1 b)/s^2 at s=1
    expected = -jnp.sum(jnp.linalg.solve(A0, b))
    np.testing.assert_allclose(np.asarray(g), np.asarray(expected), rtol=1e-4)
