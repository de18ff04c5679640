"""gan_mpc_tpu — a JAX GAN-MPC imitation-learning framework.

A ground-up JAX/XLA re-design of the capabilities of the reference
``gan_mpc`` package (model-based imitation learning via learned-cost /
learned-dynamics MPC, trained either with an L2 outer loss or adversarially
against a sequence critic).

Design stance (differs deliberately from the reference):
  * the environment is a pure-JAX physics step, so the whole
    plan-act-learn loop is ONE jitted, shardable XLA program — no
    per-control-step host round trips;
  * the iLQR planner is an in-repo, fully-jitted ``lax.scan`` program with
    a fixed-shape parallel line search (replaces the external trajax dep);
  * the bilevel "differentiate through the planner" gradient is an
    implicit-function-theorem ``jax.custom_vjp`` on the planner, so outer
    losses are ordinary differentiable JAX code;
  * data buffers / normalizers are device-resident pytrees;
  * scale-out is a ``jax.sharding.Mesh`` + ``shard_map`` over batched
    env+planner instances with ``psum`` gradient reduction.
"""

__version__ = "0.1.0"
