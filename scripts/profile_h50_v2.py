"""Per-phase timing of the H=50 batch solver with AMORTIZED dispatch.

Every phase runs inside ONE jit under a fori_loop with a carried data
dependency, so per-call dispatch overhead amortizes across REPS
iterations and the loop can't be DCE'd or parallelized away.

Usage: python scripts/profile_h50_v2.py [B] [T] [REPS]
"""

import sys
import time

sys.path.insert(0, ".")

from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from gan_mpc_tpu.planner.batch_ilqr import (  # noqa: E402
    _backward,
    _forward_best,
    _line_search_objs,
    batch_rollout,
)
from gan_mpc_tpu.planner.ilqr import SolverSettings  # noqa: E402

B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
T = int(sys.argv[2]) if len(sys.argv) > 2 else 50
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 20
N, M = 29, 12


def amortized(name, make_fn, *args):
    """make_fn(*args) -> (loop_body, init_carry); time REPS iterations
    inside one jit."""
    body, init = make_fn(*args)

    @jax.jit
    def run(c):
        return jax.lax.fori_loop(0, REPS, body, c)

    out = run(init)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(init)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS * 1e3
    print(f"{name:46s} {dt:8.3f} ms", flush=True)
    return dt


def main():
    policy, params, _, _ = ge._flagship(
        horizon=T, max_iterations=5, x_size=N, u_size=M,
    )
    settings = SolverSettings(max_iterations=5)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 8)
    hx = 0.1 * jax.random.normal(ks[0], (B, 2, N))
    hu = jnp.zeros((B, 1, M))

    # Build the problem exactly as plan_batch does, via a probe plan.
    # (We re-enter plan_batch pieces by calling the internal codepath.)
    from gan_mpc_tpu.planner import batch_ilqr as bi

    captured = {}
    orig = bi.batch_ilqr

    def capture(problem, x0, U0, settings_):
        captured.update(problem=problem, x0=x0, U0=U0, settings=settings_)
        return orig(problem, x0, U0, settings_)

    bi.batch_ilqr = capture
    try:
        import gan_mpc_tpu.policies.mpc as mpc_mod

        mpc_mod.batch_ilqr = capture
        sol = policy.plan_batch(params, hx, hu)
        jax.block_until_ready(sol.obj)
    finally:
        bi.batch_ilqr = orig
        import gan_mpc_tpu.policies.mpc as mpc_mod

        mpc_mod.batch_ilqr = orig
    problem = captured["problem"]
    x0 = captured["x0"]
    U0 = jnp.swapaxes(captured["U0"], 0, 1)  # (T, B, m)
    st = captured["settings"]
    print(f"solver iterations used: {sol.iterations}"[:90], flush=True)

    X0, _ = batch_rollout(problem, U0, x0)
    A, Bm = problem.dynamics_jac(X0[:-1], U0)
    cx, cu, cxx, cuu, cux = problem.quad(X0, U0)
    reg = jnp.full((B,), 1e-6, jnp.float32)
    k, K, _, _, _, _ = _backward(A, Bm, cx, cu, cxx, cuu, cux, reg, st)
    alphas = st.alpha_0 * (
        st.alpha_decay ** jnp.arange(st.num_alphas, dtype=jnp.float32)
    )
    alpha_b = jnp.full((B,), 0.5, jnp.float32)

    def mk_rollout():
        def body(i, c):
            X, _ = batch_rollout(problem, U0 + 1e-6 * c, x0)
            return X[0, :, 0].sum()

        return body, jnp.zeros(())

    def mk_jac():
        def body(i, c):
            A_, Bm_ = problem.dynamics_jac(X0[:-1] + 1e-6 * c, U0)
            return A_[0, 0, 0, 0] + Bm_[0, 0, 0, 0]

        return body, jnp.zeros(())

    def mk_quad():
        def body(i, c):
            cx_, *_ = problem.quad(X0 + 1e-6 * c, U0)
            return cx_[0, 0, 0]

        return body, jnp.zeros(())

    def mk_backward():
        def body(i, c):
            k_, K_, dv1, _, _, _ = _backward(
                A, Bm, cx + 1e-6 * c, cu, cxx, cuu, cux, reg, st
            )
            return k_[0, 0, 0] + dv1[0]

        return body, jnp.zeros(())

    def mk_ls(materialize):
        def body(i, c):
            out = _line_search_objs(
                problem, X0, U0 + 1e-6 * c, k, K, alphas,
                materialize=materialize,
            )
            objs = out[0] if materialize else out
            return objs[0, 0]

        return body, jnp.zeros(())

    def mk_fb():
        def body(i, c):
            _, _, obj = _forward_best(
                problem, X0, U0 + 1e-6 * c, k, K, alpha_b
            )
            return obj[0]

        return body, jnp.zeros(())

    t_ro = amortized("forward batch_rollout (1 T-scan)", mk_rollout)
    t_j = amortized("dynamics_jac (T*B fused)", mk_jac)
    t_q = amortized("cost quad_batch", mk_quad)
    t_b = amortized("backward Riccati (fused-block)", mk_backward)
    t_l = amortized("line search objs (recompute carry)", mk_ls, False)
    t_lm = amortized("line search objs (materialize)", mk_ls, True)
    t_f = amortized("forward_best (winner recompute)", mk_fb)

    it = t_j + t_q + t_b + t_l + t_f
    print(f"-- per-iteration (jac+quad+bwd+ls+fb)        {it:8.3f} ms")
    print(f"-- 5 iters + rollout                         "
          f"{5 * it + t_ro:8.3f} ms")


if __name__ == "__main__":
    main()
