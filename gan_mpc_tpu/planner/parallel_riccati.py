"""Parallel-in-time Riccati backward pass via associative scan.

For long horizons (H >= 50, BASELINE.json configs[4]) the sequential
Riccati recursion is latency-bound: T tiny dependent steps. This
module computes the same time-varying LQR value functions in O(log T)
depth with ``jax.lax.associative_scan``, following the temporal-
parallelization construction of Särkkä & García-Fernández (2021): each
time step becomes an element of an associative semigroup of conditional
value functions; combining elements composes segments.

Representation. A segment [k, l) is summarized by (A, b, C, eta, J) s.t.

    E(x_k, x_l) = 1/2 x_k^T J x_k - eta^T x_k + 1/2 |w|^2,
    with x_l = A x_k + b + M w  and  C = M M^T,

i.e. quadratic start-cost plus a "control-noise" channel reaching x_l.
Composition over the shared midpoint gives, with D = I + C1 J2:

    A12  = A2 D^{-1} A1
    b12  = A2 D^{-1} (b1 + C1 eta2_b) + b2        (eta2_b := -eta2 sign
    C12  = A2 D^{-1} C1 A2^T + C2                  convention below)
    J12  = A1^T J2 D^{-1} A1 + J1
    eta12 = A1^T (I + J2 C1)^{-1} (eta2 - J2 b1) + eta1

Cross terms (c_ux) are removed up front by completing the square
(u = u~ - U^{-1} S x), and linear control cost r folds into the offset
b = -L U^{-1} r. The value function at k is then V_k(x) = 1/2 x^T J x -
eta^T x of the suffix element [k, T], from which the usual gains are
recovered pointwise (vmapped over time).

Verified exactly (to fp tolerance) against the sequential backward pass
in ``tests/test_parallel_riccati.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gan_mpc_tpu.planner.linalg import solve_spd


def _combine(earlier, later):
    """Compose segment ``earlier`` (in time) with ``later``.

    Works on arbitrarily batched elements (associative_scan passes blocks
    with a leading axis), so all products are written batch-safely.
    """
    A1, b1, C1, eta1, J1 = earlier
    A2, b2, C2, eta2, J2 = later
    n = A1.shape[-1]
    eye = jnp.eye(n, dtype=A1.dtype)
    mT = lambda M: jnp.swapaxes(M, -1, -2)
    mv = lambda M, v: jnp.einsum("...ij,...j->...i", M, v)
    D = eye + C1 @ J2
    Dt = eye + J2 @ C1  # = D^T when C1, J2 symmetric
    solve_v = lambda M, v: jnp.linalg.solve(M, v[..., None])[..., 0]
    A12 = A2 @ jnp.linalg.solve(D, A1)
    b12 = mv(A2, solve_v(D, b1 + mv(C1, eta2))) + b2
    C12 = A2 @ jnp.linalg.solve(D, C1) @ mT(A2) + C2
    C12 = (C12 + mT(C12)) / 2.0
    eta12 = mv(mT(A1), solve_v(Dt, eta2 - mv(J2, b1))) + eta1
    J12 = mT(A1) @ (J2 @ jnp.linalg.solve(D, A1)) + J1
    J12 = (J12 + mT(J12)) / 2.0
    return (A12, b12, C12, eta12, J12)


def parallel_backward_pass(A, B, cx, cu, cxx, cuu, cux, reg, psd_delta=0.0):
    """Drop-in replacement for the sequential Riccati backward pass.

    A: (T, n, n), B: (T, n, m); cx/cxx: (T+1, ...) incl. terminal;
    cu/cuu/cux: (T+1, ...) with the terminal row ignored.
    Returns (k, K, Qu, dv1, dv2, adjoints) identical in meaning to
    ``ilqr._backward_pass``.
    """
    del psd_delta  # LM regularization only in the parallel pass
    T = A.shape[0]
    n, m = B.shape[1], B.shape[2]
    eye_m = jnp.eye(m, dtype=A.dtype)

    # Elements use a FIXED tiny ridge (U must be invertible); the
    # LM regularizer `reg` applies only to the pointwise gain recovery
    # below — matching the sequential pass, which regularizes the gain
    # solve but propagates the unregularized value function. Folding a
    # large reg into the elements distorts the value function globally
    # and stalls convergence when the line search drives reg up.
    U = cuu[:T] + 1e-6 * eye_m  # (T, m, m) control cost for the elements
    S = cux[:T]  # (T, m, n)
    q = cx[:T]
    r = cu[:T]
    X = cxx[:T]

    # Complete the square to remove cross terms: u = u~ - U^{-1} S x.
    Uinv_S = solve_spd(U, S)  # (T, m, n)
    Uinv_r = solve_spd(U, r[..., None])[..., 0]  # (T, m)
    F_t = A - jnp.einsum("tnm,tmk->tnk", B, Uinv_S)
    X_t = X - jnp.einsum("tmn,tmk->tnk", S, Uinv_S)
    X_t = (X_t + jnp.swapaxes(X_t, 1, 2)) / 2.0
    # PSD-project the stage state costs: with indefinite curvature (any
    # nonconvex cost) the exact unregularized value recursion can diverge
    # over long horizons; the sequential pass sidesteps this by
    # propagating V with its regularized gains. Clamping eigenvalues >= 0
    # is the standard make-psd treatment and keeps the semigroup elements
    # well-posed. Gains below still use the ORIGINAL curvature + reg.
    def _psd(Ms):
        w, v = jnp.linalg.eigh(Ms)
        w = jnp.maximum(w, 0.0)
        return jnp.einsum("tij,tj,tkj->tik", v, w, v)

    X_t = _psd(X_t)
    q_t = q - jnp.einsum("tmn,tm->tn", S, Uinv_r)

    # Per-step elements: eta = -q (E = ... - eta^T x), b = -L U^{-1} r,
    # C = L U^{-1} L^T  with L = B.
    Uinv_Bt = solve_spd(U, jnp.swapaxes(B, 1, 2))  # (T, m, n)
    C_el = jnp.einsum("tnm,tmk->tnk", B, Uinv_Bt)
    b_el = -jnp.einsum("tnm,tm->tn", B, Uinv_r)
    elems = (
        F_t,
        b_el,
        C_el,
        -q_t,
        X_t,
    )
    # Terminal element: pure cost, no transition (same PSD treatment).
    zeros_n = jnp.zeros((1, n, n), A.dtype)
    term = (
        zeros_n,
        jnp.zeros((1, n), A.dtype),
        zeros_n,
        -cx[T][None],
        _psd(cxx[T][None]),
    )
    elems = jax.tree_util.tree_map(
        lambda e, t: jnp.concatenate([e, t], axis=0), elems, term
    )

    # Suffix combination via associative scan on the time-reversed array:
    # fn(u, v) combines u (later segment) with v (the next earlier one).
    rev = jax.tree_util.tree_map(lambda e: e[::-1], elems)
    suffix_rev = jax.lax.associative_scan(
        lambda u, v: _combine(v, u), rev, axis=0
    )
    suffix = jax.tree_util.tree_map(lambda e: e[::-1], suffix_rev)
    P = suffix[4]  # (T+1, n, n) value Hessians
    p = -suffix[3]  # (T+1, n) value linear terms

    # Pointwise gain recovery from V_{t+1} (vmapped over time).
    def gains(Bt, cuut, cut, cuxt, At, P1, p1):
        Quu = cuut + Bt.T @ P1 @ Bt + reg * eye_m
        Qu = cut + Bt.T @ p1
        Qux = cuxt + Bt.T @ P1 @ At
        kK = solve_spd(
            Quu, jnp.concatenate([Qu[:, None], Qux], axis=1)
        )
        k, K = -kK[:, 0], -kK[:, 1:]
        dv1 = jnp.dot(k, Qu)
        dv2 = 0.5 * jnp.dot(k, (cuut + Bt.T @ P1 @ Bt) @ k)
        return k, K, Qu, dv1, dv2

    k, K, Qu, dv1s, dv2s = jax.vmap(gains)(
        B, cuu[:T], cu[:T], cux[:T], A, P[1:], p[1:]
    )
    adjoints = p
    return k, K, Qu, jnp.sum(dv1s), jnp.sum(dv2s), adjoints
