"""Frozen dataclasses that are JAX pytrees.

``pytree_dataclass`` makes a class a frozen dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it ``.replace(**changes)``.
Fields declared with ``static_field`` are static metadata: they are part of
the tree structure (and so of a jit cache key), not leaves.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(default):
    """A dataclass field kept as static pytree metadata."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
