"""Batch-major MLP op tests: the value-and-Jacobian chain against
autodiff of the plain forward, in both chain directions and in bf16."""

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.ops.fused_mlp import mlp_apply, mlp_params

KEY = jax.random.PRNGKey(0)


def test_value_and_jac_both_chain_directions():
    """The Jacobian chain picks its side by fin vs fout; both must match
    jacfwd of the reference forward. Covers the planner's dynamics shape
    (fin = n+m > fout = n -> output-side chain) and the input-side case."""
    from gan_mpc_tpu.ops.fused_mlp import mlp_value_and_jac

    for sizes in [[7, 24, 24, 4], [4, 16, 9], [3, 8]]:
        params = mlp_params(KEY, sizes)
        x = jax.random.normal(jax.random.PRNGKey(2), (11, sizes[0]))
        y, J = mlp_value_and_jac(x, params)
        y_ref = mlp_apply(x, params)
        J_ref = jax.vmap(
            jax.jacfwd(lambda xi: mlp_apply(xi[None], params)[0])
        )(x)
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-5)
        np.testing.assert_allclose(np.asarray(J), np.asarray(J_ref), atol=1e-5)


def test_value_and_jac_bf16_close_to_f32():
    """bfloat16 GEMMs with f32 accumulation: same structure, small
    relative error (the batch solver's compute_dtype="bfloat16" path)."""
    from gan_mpc_tpu.ops.fused_mlp import mlp_value_and_jac

    sizes = [7, 32, 32, 5]
    params = mlp_params(KEY, sizes)
    x = jax.random.normal(jax.random.PRNGKey(3), (11, 7))
    y32, J32 = mlp_value_and_jac(x, params)
    yb, Jb = mlp_value_and_jac(x, params, jnp.bfloat16)
    assert yb.dtype == jnp.float32 and Jb.dtype == jnp.float32
    scale = float(jnp.max(jnp.abs(J32))) + 1e-9
    assert float(jnp.max(jnp.abs(Jb - J32))) / scale < 0.03
    ya = mlp_apply(x, params, jnp.bfloat16)
    assert ya.dtype == jnp.float32
    yscale = float(jnp.max(jnp.abs(y32))) + 1e-9
    assert float(jnp.max(jnp.abs(ya - y32))) / yscale < 0.03
