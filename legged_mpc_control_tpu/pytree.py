"""Frozen dataclasses that are JAX pytrees: every field is a child, in
declaration order, and `.replace(**changes)` returns an updated copy."""

import dataclasses

import jax


def dataclass(cls):
    """Class decorator: frozen dataclass registered as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = dataclasses.replace
    return cls
