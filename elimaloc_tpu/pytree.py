"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` turns a class into a frozen dataclass whose fields are pytree
children, except fields declared with ``field(pytree_node=False)``: those are
static auxiliary data, part of the tree structure and so of the jit cache
key. Instances gain ``.replace(**updates)``, a functional update.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    """A copy with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
