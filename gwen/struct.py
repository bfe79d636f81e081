"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children
unless declared ``field(pytree_node=False)``, in which case they are static
metadata (part of the treedef, hashed into jit cache keys). Instances get a
``replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
