"""Batch-native iLQR: one solver instance for a whole (B,)-batch of
planning problems.

``ilqr.py`` solves a single problem and is batched from outside with
``jax.vmap`` — correct, but the callbacks then trace per-instance, so
fused batch ops (``ops/fused_mlp.py``) can never see the real batch, and
the outer ``while_loop`` under vmap makes every lane run lockstep anyway.
This module is the batch-major formulation (the round-1 ROADMAP's #1
item): every callback receives the WHOLE batch, the iteration loop is a
single ``while_loop`` whose condition is "any lane still active", and
per-lane convergence / line-search / Levenberg-Marquardt state is carried
as (B,) arrays with masked updates. Matches ``vmap(ilqr)`` numerically
(``tests/test_batch_ilqr.py``).

Performance notes (design choices made on the solver's first
accelerator; none re-measured on the GPU yet):

  * all horizon-indexed arrays are TIME-MAJOR internally — X (T+1, B, n),
    U (T, B, m), A (T, B, n, n) — so every ``lax.scan`` consumes its
    inputs without per-iteration transposes, and flattening to (T*B)
    rows for the fused whole-horizon callbacks is a free reshape;
  * the line search only accumulates objectives (carry (B, A)); the
    winning trajectory is recomputed ONCE at each lane's best step size
    instead of stacking all A candidate trajectories and gathering;
  * cost quadratization is closed-form (see ``MPCCost.quad_batch``) and
    the dynamics linearization is a fused value-and-Jacobian
    (``ops.fused_mlp.mlp_value_and_jac``) — no AD in the iteration loop;
  * the tiny SPD gain solves use the unrolled Gauss-Jordan
    (``planner/linalg.py``), not a LAPACK custom call.

Reference provenance: same planner contract as trajax's ilqr
(``/root/reference/policy/optimizers.py:10-21``); the batch formulation
is new — the reference is single-instance, single-device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp

from gan_mpc_tpu.planner.ilqr import ILQRSolution, SolverSettings
from gan_mpc_tpu.planner.linalg import solve_spd


@dataclasses.dataclass(frozen=True)
class BatchProblem:
    """Batch-major planner callbacks.

    dynamics_step: (X (B,K,n), U (B,K,m), t) -> (B,K,n) — K parallel
      rollouts per lane (K=1 plain rollout, K=num_alphas line search);
    dynamics_jac: (X (T,B,n), U (T,B,m)) -> (A (T,B,n,n), Bm (T,B,n,m));
    stage_cost: (X (B,K,n), U (B,K,m), t) -> (B,K);
    terminal_cost: (X (B,K,n)) -> (B,K);
    quad: (X (T+1,B,n), U (T,B,m)) -> (cx (T+1,B,n), cu (T,B,m),
      cxx (T+1,B,n,n), cuu (T,B,m,m), cux (T,B,m,n)).
    """

    dynamics_step: Callable
    dynamics_jac: Callable
    stage_cost: Callable
    terminal_cost: Callable
    quad: Callable

    def __hash__(self):
        return hash(
            (self.dynamics_step, self.dynamics_jac, self.stage_cost,
             self.terminal_cost, self.quad)
        )


def batch_rollout(problem: BatchProblem, U, x0, unroll=1):
    """U (T,B,m), x0 (B,n) -> X (T+1,B,n), obj (B,)."""
    T = U.shape[0]

    def step(carry, inp):
        x, acc = carry
        u, t = inp
        acc = acc + problem.stage_cost(x[:, None], u[:, None], t)[:, 0]
        nx = problem.dynamics_step(x[:, None], u[:, None], t)[:, 0]
        return (nx, acc), nx

    (xT, acc), tail = jax.lax.scan(
        step,
        (x0, jnp.zeros(x0.shape[0], x0.dtype)),
        (U, jnp.arange(T)),
        unroll=unroll,
    )
    X = jnp.concatenate([x0[None], tail], axis=0)
    obj = acc + problem.terminal_cost(xT[:, None])[:, 0]
    return X, obj


def _backward(A, Bm, cx, cu, cxx, cuu, cux, reg, settings):
    """Batched Riccati recursion (all inputs time-major). reg: (B,).

    The open-loop costate recursion (``_adjoint_gradient``) rides in the
    SAME reverse scan — at long horizons every extra length-T scan is a
    latency cost (T tiny dependent steps), so the gradient's two small
    einsums are fused into the Riccati step instead of paying a second
    T-step loop per solver iteration. Returns (k, K, dv1, dv2, adjoints,
    G) with G (T, B, m) = exact dJ/dU, identical to the standalone
    recursion.

    Block formulation (round-5 long-horizon latency work): with the
    composite linearization C = [A | B] (B, n, n+m), the whole Q-model
    assembles in THREE fat batched GEMMs per step —

        [Qx; Qu]           = [cx; cu] + Cᵀ Vx        (ridden with lam)
        Q = [[Qxx, Qxu],
             [Qux, Quu]]   = Cblock + (Cᵀ Vxx) C

    and the value recursion collapses through S = [I; K] (B, n+m, n)
    and d = [0; k]:

        Vx'  = Sᵀ ([Qx; Qu] + Q d)
        Vxx' = Sᵀ Q S,   Δ₁ = kᵀQu,  Δ₂ = ½ dᵀ Q d

    — algebraically identical to the classical per-block recursion but
    ~half the per-step kernel count, with every GEMM at the fatter
    (n+m)-wide shape (better matrix-unit tiling for the small state dims MPC
    uses). Cblock and the stacked cost vector are assembled ONCE for the
    whole horizon outside the scan (vectorized over T).
    """
    B = A.shape[1]
    n = A.shape[-1]
    m = Bm.shape[-1]
    nm = n + m

    # whole-horizon precomputation (big vectorized ops, outside the scan)
    C = jnp.concatenate([A, Bm], axis=-1)  # (T, B, n, n+m)
    qc = jnp.concatenate([cx[:-1], cu], axis=-1)  # (T, B, n+m)
    cuxT = jnp.swapaxes(cux, -1, -2)  # (T, B, n, m)
    top = jnp.concatenate([cxx[:-1], cuxT], axis=-1)  # (T, B, n, n+m)
    bot = jnp.concatenate([cux, cuu], axis=-1)  # (T, B, m, n+m)
    cblock = jnp.concatenate([top, bot], axis=-2)  # (T, B, n+m, n+m)
    eye_b = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), (B, n, n))
    reg_eye = reg[:, None, None] * jnp.eye(m, dtype=A.dtype)

    def step(carry, inp):
        Vx, Vxx, dv1, dv2, lam = carry
        Ct, qct, cbt = inp
        # [Qx;Qu] and the costate map share one Cᵀ[...] GEMM
        P = jnp.stack([Vx, lam], axis=-1)  # (B, n, 2)
        R = jnp.einsum("bnp,bnk->bpk", Ct, P)  # (B, n+m, 2)
        q = qct + R[..., 0]  # [Qx; Qu]
        lamg = qct + R[..., 1]  # [lam'; g]
        M = jnp.einsum("bnp,bnq->bpq", Ct, Vxx)  # Cᵀ Vxx (B, n+m, n)
        Q = cbt + M @ Ct  # (B, n+m, n+m)
        Qu = q[:, n:]
        Quu_reg = Q[:, n:, n:] + reg_eye
        kK = solve_spd(
            Quu_reg,
            jnp.concatenate([Qu[..., None], Q[:, n:, :n]], axis=-1),
        )
        k, K = -kK[..., 0], -kK[..., 1:]
        S = jnp.concatenate([eye_b, K], axis=1)  # (B, n+m, n)
        Qd = jnp.einsum("bpj,bj->bp", Q[:, :, n:], k)  # Q [0; k]
        Vx_new = jnp.einsum("bpn,bp->bn", S, q + Qd)
        T1 = Q @ S  # (B, n+m, n)
        Vxx_new = jnp.einsum("bpn,bpm->bnm", S, T1)
        Vxx_new = (Vxx_new + jnp.swapaxes(Vxx_new, -1, -2)) / 2.0
        dv1 = dv1 + jnp.einsum("bi,bi->b", k, Qu)
        dv2 = dv2 + 0.5 * jnp.einsum("bi,bi->b", k, Qd[:, n:])
        return (Vx_new, Vxx_new, dv1, dv2, lamg[:, :n]), (
            k, K, Vx_new, lamg[:, n:],
        )

    zero = jnp.zeros(B, A.dtype)
    (_, _, dv1, dv2, _), (k, K, Vxs, G) = jax.lax.scan(
        step,
        (cx[-1], cxx[-1], zero, zero, cx[-1]),
        (C, qc, cblock),
        reverse=True,
        unroll=settings.inner_unroll,
    )
    adjoints = jnp.concatenate([Vxs, cx[-1:]], axis=0)
    return k, K, dv1, dv2, adjoints, G


def _backward_associative(A, Bm, cx, cu, cxx, cuu, cux, reg, settings):
    """O(log T)-depth backward pass for the batch solver.

    Wraps ``parallel_riccati.parallel_backward_pass`` (the Särkkä &
    García-Fernández temporal-parallelization construction, already
    verified against the sequential recursion) with ``jax.vmap`` over the
    lane axis — vmap of an ``associative_scan`` IS the batched
    associative scan, so all lanes advance through the same log-depth
    combine tree. The open-loop gradient comes from an associative
    composition of the affine costate maps lam_t = A^T lam_{t+1} + cx_t
    (one more log-depth scan instead of a length-T sequential loop).
    Same return contract as ``_backward``.
    """
    from gan_mpc_tpu.planner.parallel_riccati import parallel_backward_pass

    T = A.shape[0]
    # parallel_backward_pass wants cu/cuu/cux with a (ignored) terminal
    # row: pad with zeros.
    pad = lambda a: jnp.concatenate([a, jnp.zeros_like(a[:1])], axis=0)

    def one_lane(A_l, B_l, cx_l, cu_l, cxx_l, cuu_l, cux_l, reg_l):
        k, K, _, dv1, dv2, adjoints = parallel_backward_pass(
            A_l, B_l, cx_l, pad(cu_l), cxx_l, pad(cuu_l), pad(cux_l),
            reg_l, settings.psd_delta,
        )
        return k, K, dv1, dv2, adjoints

    k, K, dv1, dv2, adjoints = jax.vmap(
        one_lane,
        in_axes=(1, 1, 1, 1, 1, 1, 1, 0),
        out_axes=(1, 1, 0, 0, 1),
    )(A, Bm, cx, cu, cxx, cuu, cux, reg)

    # Associative costate: suffix products of f_t(lam) = A_t^T lam + cx_t
    # applied to lam_T = cx_T give lam_t; g_t = cu_t + B_t^T lam_{t+1}.
    M = jnp.swapaxes(A, -1, -2)  # (T, B, n, n)
    v = cx[:-1]

    def combine(later, earlier):
        # suffix scan on the time-reversed array: ``later`` is the
        # already-combined segment closer to T
        M2, v2 = later
        M1, v1 = earlier
        return (M1 @ M2, jnp.einsum("...ij,...j->...i", M1, v2) + v1)

    Mr, vr = jax.lax.associative_scan(
        combine, (M[::-1], v[::-1]), axis=0
    )
    suffix_M, suffix_v = Mr[::-1], vr[::-1]
    # lam_t for t in [0, T): apply segment [t, T) to lam_T
    lam = (
        jnp.einsum("tbij,bj->tbi", suffix_M, cx[-1]) + suffix_v
    )  # (T, B, n) = lam_0..lam_{T-1}
    lam_next = jnp.concatenate([lam[1:], cx[-1:]], axis=0)  # lam_1..lam_T
    G = cu + jnp.einsum("tbji,tbj->tbi", Bm, lam_next)
    return k, K, dv1, dv2, adjoints, G


def _adjoint_gradient(A, Bm, cx, cu, unroll=1):
    """Exact per-lane open-loop gradient dJ/dU (T,B,m) via the costate
    recursion (cf. ``ilqr._adjoint_gradient``); inputs time-major."""

    def step(lam, inp):
        At, Bt, cxt, cut = inp
        g = cut + jnp.einsum("bji,bj->bi", Bt, lam)
        lam_new = cxt + jnp.einsum("bji,bj->bi", At, lam)
        return lam_new, g

    _, G = jax.lax.scan(
        step, cx[-1], (A, Bm, cx[:-1], cu), reverse=True, unroll=unroll
    )
    return G


def _line_search_objs(problem, X, U, k, K, alphas, unroll=1,
                      materialize=False):
    """Objective of every (lane, alpha) closed-loop rollout: (B, A).

    ``materialize=False``: only the running objective is carried — no
    candidate trajectories are materialized; the winner is recomputed
    once afterwards (``_forward_best``). Right when B*A*T*(n+m) is large
    (the cheetah-class 512-env regime) — HBM traffic would exceed the
    recompute scan.

    ``materialize=True``: the candidate states/actions are emitted as
    scan outputs ((T, B, A, n), (T, B, A, m)) so the winner is a cheap
    gather and the recompute scan is ELIDED entirely. Right at long
    horizons where every extra length-T scan is a latency cost and the
    candidate block is small (humanoid-class H=50: ~12 MB). Returns
    (objs, (Xc, Uc)) in that mode.
    """
    B = X.shape[1]
    A_ = alphas.shape[0]
    x0 = jnp.broadcast_to(X[0][:, None], (B, A_, X.shape[-1]))

    def step(carry, inp):
        x, acc = carry
        Xref, Uref, kt, Kt, t = inp
        du = jnp.einsum("bmn,ban->bam", Kt, x - Xref[:, None])
        u = Uref[:, None] + alphas[None, :, None] * kt[:, None] + du
        acc = acc + problem.stage_cost(x, u, t)
        nx = problem.dynamics_step(x, u, t)
        out = (nx, u) if materialize else None
        return (nx, acc), out

    (xT, acc), out = jax.lax.scan(
        step,
        (x0, jnp.zeros((B, A_), X.dtype)),
        (X[:-1], U, k, K, jnp.arange(U.shape[0])),
        unroll=unroll,
    )
    objs = acc + problem.terminal_cost(xT)
    return (objs, out) if materialize else objs


def _forward_best(problem, X, U, k, K, alpha_b, unroll=1):
    """Closed-loop rollout at each lane's OWN step size alpha_b (B,).
    Returns Xn (T+1,B,n), Un (T,B,m), obj (B,)."""
    B = X.shape[1]

    def step(carry, inp):
        x, acc = carry
        Xref, Uref, kt, Kt, t = inp
        u = (
            Uref
            + alpha_b[:, None] * kt
            + jnp.einsum("bmn,bn->bm", Kt, x - Xref)
        )
        acc = acc + problem.stage_cost(x[:, None], u[:, None], t)[:, 0]
        nx = problem.dynamics_step(x[:, None], u[:, None], t)[:, 0]
        return (nx, acc), (nx, u)

    (xT, acc), (tail, Un) = jax.lax.scan(
        step,
        (X[0], jnp.zeros(B, X.dtype)),
        (X[:-1], U, k, K, jnp.arange(U.shape[0])),
        unroll=unroll,
    )
    Xn = jnp.concatenate([X[:1], tail], axis=0)
    return Xn, Un, acc + problem.terminal_cost(xT[:, None])[:, 0]


@functools.partial(jax.jit, static_argnums=(0, 3))
def batch_ilqr(
    problem: BatchProblem,
    x0: jax.Array,
    U0: jax.Array,
    settings: SolverSettings = SolverSettings(),
) -> ILQRSolution:
    """Solve B planning problems jointly. x0 (B,n), U0 (B,T,m).

    Returns an ILQRSolution whose leaves carry a LEADING BATCH axis
    (X (B,T+1,n), U (B,T,m), ...). Per-lane line-search acceptance,
    Levenberg-Marquardt schedule, and convergence: a finished lane
    freezes while others iterate; the loop exits when all lanes are done
    or at their iteration cap.
    """
    x0 = x0.astype(jnp.float32)
    U0 = jnp.swapaxes(U0.astype(jnp.float32), 0, 1)  # -> (T, B, m)
    T, B, m = U0.shape
    n = x0.shape[-1]
    alphas = settings.alpha_0 * (
        settings.alpha_decay
        ** jnp.arange(settings.num_alphas, dtype=jnp.float32)
    )
    unroll = settings.inner_unroll
    # Static line-search strategy (shapes are static under jit): elide
    # the winner-recompute scan when the full candidate block is cheap
    # to materialize relative to one more length-T latency-bound scan.
    cand_bytes = 4 * T * B * settings.num_alphas * (n + m)
    mat = settings.ls_materialize == "materialize" or (
        settings.ls_materialize == "auto"
        and T >= 16
        and cand_bytes <= 32 * 1024 * 1024
    )

    X0, obj0 = batch_rollout(problem, U0, x0, unroll=unroll)
    state0 = dict(
        X=X0,
        U=U0,
        obj=obj0,
        grad=jnp.full((T, B, m), jnp.inf, jnp.float32),
        adj=jnp.zeros((T + 1, B, n), jnp.float32),
        reg=jnp.full((B,), settings.reg_init, jnp.float32),
        it=jnp.zeros((B,), jnp.int32),
        active=jnp.ones((B,), bool),
        converged=jnp.zeros((B,), bool),
    )

    def cond(s):
        # Lanes deactivate themselves at the iteration cap, so "anyone
        # still active" is the complete loop condition.
        return jnp.any(s["active"])

    def body(s):
        X, U, obj, reg = s["X"], s["U"], s["obj"], s["reg"]
        A, Bm = problem.dynamics_jac(X[:-1], U)
        cx, cu, cxx, cuu, cux = problem.quad(X, U)
        # gradient + gains come out of ONE reverse scan (see _backward);
        # settings.riccati selects the O(log T)-depth associative pass
        # for long horizons
        backward = (
            _backward_associative
            if settings.riccati == "associative"
            else _backward
        )
        k, K, dv1, dv2, adjoints, grad = backward(
            A, Bm, cx, cu, cxx, cuu, cux, reg, settings
        )
        gnorm = jnp.sqrt(jnp.sum(grad * grad, axis=(0, 2)))
        grad_small = gnorm < settings.grad_norm_tol

        ls = _line_search_objs(
            problem, X, U, k, K, alphas, unroll, materialize=mat
        )
        objs, cand = ls if mat else (ls, None)
        objs = jnp.where(jnp.isfinite(objs), objs, jnp.inf)
        best = jnp.argmin(objs, axis=1)  # (B,)
        best_obj = jnp.take_along_axis(objs, best[:, None], axis=1)[:, 0]
        improved = best_obj < obj
        take = s["active"] & ~grad_small & improved
        if mat:
            # winner = gather over the alpha axis; states get X[0] back
            # on front (the scan emits x_1..x_T)
            Xc, Uc = cand
            sel = best[None, :, None, None]
            Xb_tail = jnp.take_along_axis(
                Xc, jnp.broadcast_to(sel, Xc.shape[:2] + (1, n)), axis=2
            )[:, :, 0]
            Ub = jnp.take_along_axis(
                Uc, jnp.broadcast_to(sel, Uc.shape[:2] + (1, m)), axis=2
            )[:, :, 0]
            Xb = jnp.concatenate([X[:1], Xb_tail], axis=0)
        else:
            # Recompute only the winning rollout, at each lane's own
            # alpha (losing lanes get alpha 0 == reference trajectory,
            # masked out below anyway, so the recompute stays exact for
            # them too).
            alpha_b = jnp.where(take, alphas[best], 0.0)
            Xb, Ub, _ = _forward_best(
                problem, X, U, k, K, alpha_b, unroll
            )

        mask_tb = take[None, :, None]
        Xn = jnp.where(mask_tb, Xb, X)
        Un = jnp.where(mask_tb, Ub, U)
        objn = jnp.where(take, best_obj, obj)
        adjn = jnp.where(
            (s["active"] & ~grad_small)[None, :, None], adjoints, s["adj"]
        )
        gradn = jnp.where(s["active"][None, :, None], grad, s["grad"])
        regn = jnp.where(
            s["active"],
            jnp.where(
                improved,
                jnp.maximum(reg * settings.reg_down, settings.reg_min),
                jnp.minimum(reg * settings.reg_up, settings.reg_max),
            ),
            reg,
        )
        stalled = ~improved & (reg >= settings.reg_max)
        done_now = s["active"] & (grad_small | stalled)
        if settings.obj_step_tol > 0.0:
            step_small = improved & ((obj - objn) <= settings.obj_step_tol)
            done_now = done_now | (s["active"] & step_small)
        itn = s["it"] + s["active"].astype(jnp.int32)
        active = s["active"] & ~done_now & (itn < settings.max_iterations)
        return dict(
            X=Xn,
            U=Un,
            obj=objn,
            grad=gradn,
            adj=adjn,
            reg=regn,
            it=itn,
            active=active,
            converged=s["converged"] | done_now,
        )

    s = jax.lax.while_loop(cond, body, state0)
    bm = lambda a: jnp.swapaxes(a, 0, 1)  # -> batch-major for callers
    return ILQRSolution(
        X=bm(s["X"]),
        U=bm(s["U"]),
        obj=s["obj"],
        grad=bm(s["grad"]),
        adjoints=bm(s["adj"]),
        iterations=s["it"],
        converged=s["converged"],
    )
