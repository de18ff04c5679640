from gan_mpc_tpu.ops.fused_mlp import mlp_params  # noqa: F401
