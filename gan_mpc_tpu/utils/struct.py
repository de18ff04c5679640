"""Frozen dataclasses that are JAX pytrees.

``class S(PyTreeNode)`` makes ``S`` a frozen dataclass registered with
``jax.tree_util.register_dataclass``: its fields are pytree children, so
instances pass through ``jit``/``vmap``/``scan`` unchanged, except fields
declared ``field(pytree_node=False)``, which are static metadata (part of
the treedef, hashed by ``jit``). ``s.replace(a=...)`` returns a copy with
fields replaced.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that also marks the field as a pytree child
    (default) or as static metadata (``pytree_node=False``)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: every subclass becomes a frozen, registered dataclass."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[
                f.name for f in fields if f.metadata.get("pytree_node", True)
            ],
            meta_fields=[
                f.name
                for f in fields
                if not f.metadata.get("pytree_node", True)
            ],
        )

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
