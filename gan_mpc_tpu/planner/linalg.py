"""Small-matrix linear solves without LAPACK custom calls.

The Riccati recursion solves a tiny SPD system (action dimension m <= ~8
for every task in the zoo) at every timestep of every planner instance.
``jnp.linalg.solve`` lowers to a blocked LU with row pivoting — a custom
call that (a) dominated the planner's wall-clock on the accelerator the
solver was first built for (not yet measured on the GPU) and (b) is the
LAPACK FFI call that fails to register inside large fused XLA:CPU
modules (the reason the fused single-program epoch was skipped on the
CPU harness in round 1).

``solve_spd`` replaces it with an UNROLLED Gauss-Jordan elimination for
static m <= SMALL_MAX: m rank-1 updates on the augmented system, pure
vector ops that batch over any leading dimensions and compile everywhere.
No pivoting — the planner only solves Levenberg-Marquardt-regularized SPD
matrices, whose diagonal is bounded away from zero by construction.

For m > SMALL_MAX the same pivotless elimination runs as a
``lax.fori_loop`` (rolled, so the program stays small at e.g. the dense
bilevel solve's (T*m)^2 systems) — still custom-call-free, which is what
lets the fused single-program epochs compile on CPU for horizons where
T*m exceeds the unroll budget (LAPACK's sgetrf FFI call fails to
register inside large fused XLA:CPU modules).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Unroll threshold: action dims across the zoo reach m=12 (humanoid),
# and the rolled fori_loop's dynamic slicing serializes ~6 ops per pivot
# INSIDE every Riccati scan step (measured round 5: the m=12 backward
# scan was 47% of the H=50 per-iteration cost). The unrolled form's
# static slices fuse; the bilevel's (T*m)^2 systems stay rolled.
SMALL_MAX = 16


def _solve_spd_rolled(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Pivotless Gauss-Jordan as a fori_loop (m > SMALL_MAX)."""
    m = A.shape[-1]
    aug0 = jnp.concatenate([A, B], axis=-1)  # (..., m, m + k)
    row_ax = aug0.ndim - 2

    def body(i, aug):
        row = jax.lax.dynamic_index_in_dim(
            aug, i, axis=row_ax, keepdims=False
        )  # (..., m + k)
        d = jax.lax.dynamic_index_in_dim(
            row, i, axis=row.ndim - 1, keepdims=True
        )  # (..., 1)
        piv = row / d
        col = jax.lax.dynamic_index_in_dim(
            aug, i, axis=aug.ndim - 1, keepdims=False
        )  # (..., m)
        aug = aug - col[..., :, None] * piv[..., None, :]
        return jax.lax.dynamic_update_index_in_dim(aug, piv, i, axis=row_ax)

    aug = jax.lax.fori_loop(0, m, body, aug0)
    return aug[..., m:]


def solve_spd(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve A X = B for SPD A of static size (..., m, m), B (..., m, k).

    Unrolled Gauss-Jordan for m <= SMALL_MAX (batched, custom-call-free);
    the rolled fori_loop variant otherwise (same math, small program).
    """
    m = A.shape[-1]
    if m > SMALL_MAX:
        return _solve_spd_rolled(A, B)
    aug = jnp.concatenate([A, B], axis=-1)  # (..., m, m + k)
    for i in range(m):
        piv = aug[..., i, :] / aug[..., i, i : i + 1]  # (..., m + k)
        col = aug[..., :, i]  # (..., m)
        aug = aug - col[..., :, None] * piv[..., None, :]
        aug = aug.at[..., i, :].set(piv)
    return aug[..., m:]
