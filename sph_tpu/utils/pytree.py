"""Frozen dataclasses that are JAX pytrees.

Every field is a pytree child, so an instance can be a ``jit`` argument,
a ``lax.scan`` carry or a ``tree_map`` target.  ``.replace(**changes)``
returns a copy with the named fields swapped, as ``dataclasses.replace``
does.
"""
from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Class decorator: frozen dataclass registered with ``jax.tree_util``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = tuple(f.name for f in dataclasses.fields(cls))

    def flatten_with_keys(obj):
        return ([(jax.tree_util.GetAttrKey(k), getattr(obj, k))
                 for k in names], None)

    def unflatten(_, children):
        obj = object.__new__(cls)
        for k, v in zip(names, children):
            object.__setattr__(obj, k, v)
        return obj

    jax.tree_util.register_pytree_with_keys(
        cls, flatten_with_keys, unflatten,
        flatten_func=lambda obj: ([getattr(obj, k) for k in names], None))
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
