"""Frozen dataclasses registered as JAX pytrees.

Array fields are pytree leaves; fields made with ``static_field`` are static
(hashable aux data: a change retraces a jitted function). ``.replace(**kw)``
returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field that is static under jit, not a pytree leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = dataclasses.replace
    return cls
