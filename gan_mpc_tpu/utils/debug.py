"""Debug / CI-mode numerical guards.

The reference has no sanitizers (SURVEY.md §5 "race detection" row —
single-process, nothing to race). The equivalents owed here are
numerical: NaN propagation guards and shape/finite assertions usable
inside jitted code.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp


def enable_debug_checks(nans: bool = True) -> None:
    """Turn on global NaN debugging (every jitted op checks its outputs;
    slow — CI/debug only)."""
    jax.config.update("jax_debug_nans", nans)


@contextlib.contextmanager
def debug_checks():
    """Scoped variant of ``enable_debug_checks``."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, label: str = "value") -> None:
    """Host-side finiteness check over a pytree (use at phase boundaries,
    not inside jit)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not bool(jnp.all(jnp.isfinite(leaf))):
            name = jax.tree_util.keystr(path)
            raise FloatingPointError(f"{label}{name} contains non-finite values")


def checkify_finite(x: jax.Array, label: str = "value") -> jax.Array:
    """In-jit finiteness guard via checkify-style error value: returns x
    unchanged but poisons downstream with NaN debugging when enabled."""
    return jax.lax.cond(
        jnp.all(jnp.isfinite(x)),
        lambda v: v,
        lambda v: v * jnp.float32(jnp.nan),  # trip jax_debug_nans
        x,
    )
