"""Carry env state across between the JAX package and the port.

There are no weights on the physics path: what crosses is state. Both
directions go through a nested mapping of field name to numpy array — the
JAX ``EnvState`` (with its ``Track``, ``CarState``, ``ContactState`` and
``SkidState``) after ``jax.device_get`` reads that way by attribute, so the
port needs no JAX type. The JAX dtypes are kept: int32 for ``limit_state``,
``steps``, ``tile_visited_count``, ``n_tiles``, ``ids`` and ``head``; bool
masks; float32 elsewhere.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .env import EnvState, SkidState
from .physics.collide import ContactState
from .physics.state import CarState
from .track.common import Track
from .util import resolve_device

_NESTED = {"cars": CarState, "track": Track, "contacts": ContactState, "skid": SkidState}


def _get(tree, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _to_tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.array(x)                      # a writable, contiguous copy
    if a.dtype == np.bool_:
        pass
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(dev)


def _from_tree(cls, tree, dev):
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(tree, f.name)
        kw[f.name] = (_from_tree(_NESTED[f.name], v, dev) if f.name in _NESTED
                      else _to_tensor(v, dev))
    return cls(**kw)


def env_state_from_numpy(tree, device=None) -> EnvState:
    """A batched port ``EnvState`` on ``device`` (default CUDA) from a nested
    mapping (or attribute tree) of field name to numpy array, env axis first."""
    return _from_tree(EnvState, tree, resolve_device(device))


class _Leaves:
    """A flat leaf sequence read as an attribute tree, depth first: a nested
    state's name gives the same reader, any other name the next leaf."""

    def __init__(self, leaves):
        self.it = iter(leaves)

    def __getattr__(self, name):
        return self if name in _NESTED else next(self.it)


def env_state_from_leaves(leaves, device=None) -> EnvState:
    """A batched port ``EnvState`` on ``device`` (default CUDA) from the
    numpy leaves of a state, env axis first, in the port's field order --
    depth first, nested states in place -- which is also the leaf order of
    the JAX ``EnvState`` pytree (52 leaves). This loads a state saved as
    leaves (the golden-frame fixtures) without JAX. Every tensor is a
    contiguous copy, as the kernels read them."""
    tree = _Leaves(leaves)
    state = _from_tree(EnvState, tree, resolve_device(device))
    if next(tree.it, None) is not None:
        raise ValueError("env_state_from_leaves: more leaves than EnvState has fields")
    return state


def _to_tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj.detach().cpu().numpy()


def env_state_to_numpy(state: EnvState) -> dict:
    """The port's ``EnvState`` as a nested dict of field name to numpy array."""
    return _to_tree(state)


def cars_from_numpy(tree, device=None) -> CarState:
    """A batched port ``CarState`` from a field-name tree of numpy arrays."""
    return _from_tree(CarState, tree, resolve_device(device))
