"""Test harness configuration.

Tests run on CPU with 8 virtual devices so that every mesh/shard_map code
path is exercised without accelerator hardware (the standard JAX recipe
for testing multi-device logic; see SURVEY.md §4). ``JAX_PLATFORMS``
overrides the CPU default: the tests marked ``gpu`` need the card
(``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``) and skip
elsewhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Wall-clock note (round 3): the suite is part compile-bound on this
# 1-core box. jax_disable_most_optimizations was MEASURED as a fix and
# rejected: it cuts compile ~25% on compile-heavy modules but raises
# runtime on rollout-heavy ones for a net ~5% — and broke the fused-epoch
# chunked-vs-single numerics comparison. The real lever (persistent
# compile cache, 17 min -> 2 min warm) stays opt-in below because
# jaxlib 0.9's executable serialization aborts intermittently on write.

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compile cache: warm suite runs drop from ~17 min to
# ~2 min on this 1-core box — but jaxlib 0.9's CPU executable
# (de)serialization aborts INTERMITTENTLY on write (SIGABRT in
# compilation_cache.put_executable_and_time; last reproduced 2026-08-17
# in test_fused_epoch after a round-3 probe had failed to reproduce it).
# The crash is a coin flip, so the cache stays OPT-IN:
# GAN_MPC_TPU_TEST_CACHE=1 enables it for local iteration.
if os.environ.get("GAN_MPC_TPU_TEST_CACHE", "0") == "1":
    os.environ["GAN_MPC_TPU_FORCE_COMPILE_CACHE"] = "1"
    from gan_mpc_tpu import runtime_setup

    runtime_setup.setup()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_compiler_state():
    """jaxlib 0.9's XLA:CPU backend dies (SIGSEGV/SIGABRT inside
    backend_compile_and_load) once enough compiled programs accumulate in
    one process — reproduced 3x at the same ~53% suite mark regardless of
    WHICH program compiles there. Dropping executable references after
    each test module keeps the per-process footprint bounded; cross-module
    programs recompile, which costs ~nothing since modules rarely share
    shapes."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX's default device is a GPU;
    decided here, per test, never at import."""
    if request.node.get_closest_marker("gpu") and (
        jax.devices()[0].platform != "gpu"
    ):
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
