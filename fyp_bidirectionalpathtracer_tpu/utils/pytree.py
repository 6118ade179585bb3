"""Frozen dataclasses that are JAX pytrees.

`@pytree.dataclass` makes a frozen dataclass and registers it with
`jax.tree_util.register_dataclass`: fields are pytree children unless
declared `pytree.field(pytree_node=False)`, which makes them static
metadata (hashable, part of the jit cache key).  Instances get a
`.replace(**changes)` copy method.
"""
from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """dataclasses.field with a `pytree_node` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta)
