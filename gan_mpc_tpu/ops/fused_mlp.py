"""Batch-major relu-MLP ops for the planner's hot loop.

The planner evaluates small MLPs (dynamics 23->200->200->200->17, cost
17->128->128->10 at the cheetah flagship) over whole env batches: the
line search alone applies them to 512 envs x 16 step sizes = 8192 rows
per time step. ``mlp_apply`` is the forward and ``mlp_value_and_jac`` the
forward plus the exact input Jacobian as flattened GEMM chains; both are
plain ``jnp`` that XLA compiles (cuBLAS GEMMs with bias+relu fused into
the epilogue on the GPU).

A fused single-kernel forward through Pallas/Triton was measured against
this on an H100 at 8192 rows and lost (PERF.md, PR 1), so none is kept.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def mlp_params(
    key: jax.Array, sizes: Sequence[int], dtype=jnp.float32
) -> Tuple[Tuple[jax.Array, jax.Array], ...]:
    """He-initialized (W, b) list for layer sizes [fin, h1, ..., fout]."""
    params = []
    for fin, fout in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        w = jax.random.normal(sub, (fin, fout), dtype) * jnp.sqrt(2.0 / fin)
        params.append((w, jnp.zeros((fout,), dtype)))
    return tuple(params)


def _mm(a, w, dtype):
    """GEMM at the requested compute dtype with f32 accumulation.

    dtype=None keeps plain f32. dtype=bfloat16 casts BOTH operands so the
    GEMM runs at the bf16 rate; ``preferred_element_type`` keeps the
    accumulator (and output) f32, so downstream elementwise math and the
    Riccati recursion never see bf16 rounding beyond the product terms.
    """
    if dtype is None:
        return a @ w
    return jnp.dot(
        a.astype(dtype), w.astype(dtype),
        preferred_element_type=jnp.float32,
    )


def mlp_apply(x: jax.Array, params, dtype=None) -> jax.Array:
    """relu-MLP forward on (N, fin) rows; ``dtype`` selects the GEMM
    compute dtype (see ``_mm``)."""
    h = x
    for i, (w, b) in enumerate(params):
        h = _mm(h, w, dtype) + b
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


# ---------------------------------------------------------------------------
# fused value + Jacobian (batch-native planner linearization)
# ---------------------------------------------------------------------------

def dense_stack(params) -> Tuple[Tuple[jax.Array, jax.Array], ...]:
    """((W, b), ...) from a param tree of ``Dense_<i>`` layers
    (``models/layers.py``)."""
    layers = params["params"]
    names = sorted(layers, key=lambda s: int(s.rsplit("_", 1)[1]))
    return tuple((layers[k]["kernel"], layers[k]["bias"]) for k in names)


def mlp_value_and_jac(x: jax.Array, params, dtype=None):
    """Forward value AND exact input-Jacobian of a relu MLP, batch-major.

    x: (N, fin) -> (y (N, fout), J (N, fout, fin)).

    The planner's linearization previously pushed fin tangent vectors per
    instance through ``jax.jacfwd`` (per-instance batched matmuls). Here
    the Jacobian chain is computed as flattened GEMMs with the shared
    weight — large-M GEMMs (M huge, K/N = layer widths) — with the relu
    masks from the forward pass applied between layers. Exact for relu
    networks (piecewise-linear, so the product of masked weight matrices
    IS the Jacobian a.e.).

    The chain runs from whichever side is cheaper: input-side when
    fin <= fout (tangent blocks (N*fin, h)), output-side when fout < fin
    (cotangent blocks (N*fout, h) — e.g. the planner's dynamics
    linearization has fin = n+m > fout = n, so the output-side chain
    saves a factor fin/fout on every GEMM).

    ``dtype`` selects the GEMM compute dtype (``_mm``): bfloat16 runs the
    whole chain at the bf16 rate with f32 accumulation; masks and the
    forward bias/relu tail stay f32.
    """
    n_layers = len(params)
    N, fin = x.shape
    h = x
    masks = []
    for i, (w, b) in enumerate(params):
        h = _mm(h, w, dtype) + b
        if i < n_layers - 1:
            mask = (h > 0.0).astype(h.dtype)
            h = h * mask
            masks.append(mask)
    fout = params[-1][0].shape[1]

    if fout < fin:
        # output-side (cotangent) chain:
        #   R_L = W_{L-1};  R_i = W_i diag(m_{i+1}) R_{i+1}
        # accumulated as flattened (N*fout, h) GEMMs on the transposed
        # blocks; J_rowvec = R_0 has shape (fin, fout).
        wl = params[-1][0]  # (h_{L-1}, fout)
        R = jnp.broadcast_to(wl[None], (N,) + wl.shape)
        if masks:
            R = R * masks[-1][..., None]
        for i in range(n_layers - 2, -1, -1):
            wi = params[i][0]  # (h_i, h_{i+1}); R (N, h_{i+1}, fout)
            Rt = jnp.swapaxes(R, 1, 2).reshape(N * fout, -1)
            R = _mm(Rt, wi.T, dtype).reshape(N, fout, -1)
            R = jnp.swapaxes(R, 1, 2)  # (N, h_i, fout)
            if i > 0:
                R = R * masks[i - 1][..., None]
        return h, jnp.swapaxes(R, 1, 2)  # (N, fout, fin)

    w0 = params[0][0]  # (fin, h1)
    J = jnp.broadcast_to(w0[None], (N,) + w0.shape)
    if masks:
        J = J * masks[0][:, None, :]
    for i in range(1, n_layers):
        wi = params[i][0]  # (h_i, h_{i+1})
        J = _mm(J.reshape(N * fin, -1), wi, dtype).reshape(N, fin, -1)
        if i < n_layers - 1:
            J = J * masks[i][:, None, :]
    return h, jnp.swapaxes(J, 1, 2)  # (N, fout, fin)
