"""Build the reference's state from plain trees of tensors.

The benchmark hands the reference what the timed path was given and what it
produced as nested dicts of tensors, keyed by the field names of the port's
state (the same names as the reference's dataclasses). Nothing of the port
crosses: only tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from .env import EnvState
from .physics.collide import ContactState
from .physics.state import CarState
from .render.particles import SkidState
from .track.common import Track

_CLASSES = {"cars": CarState, "track": Track, "contacts": ContactState, "skid": SkidState}


def env_state(tree: dict) -> EnvState:
    """An EnvState from a tree with EnvState's fields (and CarState's,
    Track's, ContactState's and SkidState's under theirs)."""
    kw = {}
    for f in dataclasses.fields(EnvState):
        v = tree[f.name]
        if f.name in _CLASSES:
            cls = _CLASSES[f.name]
            v = cls(**{g.name: v[g.name] for g in dataclasses.fields(cls)})
        kw[f.name] = v
    return EnvState(**kw)


def tree(obj) -> dict | torch.Tensor:
    """The nested dict of tensors of a dataclass tree, by field name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def cast(obj, dtype: torch.dtype):
    """Every floating tensor of a tree (dict, tuple or dataclass) in ``dtype``."""
    if isinstance(obj, dict):
        return {k: cast(v, dtype) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(cast(v, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: cast(getattr(obj, f.name), dtype)
                                           for f in dataclasses.fields(obj)})
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.to(dtype)
    return obj
