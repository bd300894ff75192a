"""Frozen dataclasses registered as JAX pytrees.

The filter state, the sensor parameters and the static filter parameters are
all immutable records that cross `jax.jit`, `vmap` and `shard_map`
boundaries. `pytree_dataclass` makes a class such a record: every field is
a pytree leaf (traced, so a new value does not recompile) unless it is
declared with `static_field`, in which case it is part of the tree's static
structure (hashed into the jit cache key, so a new value retraces).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field held as static pytree metadata instead of a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    """A copy with the given fields changed (dataclasses.replace)."""
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Class decorator: a frozen dataclass registered with
    `jax.tree_util.register_dataclass`, plus a `.replace(**changes)`
    method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
