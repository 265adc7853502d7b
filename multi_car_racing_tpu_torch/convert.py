"""Carry state and weights across between the JAX package and the port.

State crosses through a nested mapping of field name to numpy array: the
JAX ``EnvState`` (with its ``Track``, ``CarState``, ``ContactState`` and
``SkidState``) after ``jax.device_get`` reads that way by attribute, and so
does a ``ContactBundle`` with its ``Manifolds``, so the port needs no JAX
type. The JAX dtypes are kept: int32 for ``limit_state``, ``steps``,
``tile_visited_count``, ``n_tiles``, ``ids`` and ``head``; bool masks;
float32 elsewhere. ``env_state_*``, ``track_*``, ``cars_from_numpy`` and
``bundle_from_numpy`` convert state (a track pool is a ``Track``).

Weights cross the same way: ``policy_from_numpy`` builds the learner's
``ActorCritic`` from flax's variables dict of numpy arrays (Dense kernels
(in, out) -> (out, in), conv kernels HWIO -> OIHW, every shape checked),
with the ``obs_rms`` statistics; ``policy_to_numpy`` is its inverse.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .env import EnvState
from .render.particles import SkidState
from .physics.collide import ContactBundle, ContactState, Manifolds
from .physics.state import CarState
from .track.common import Track
from .util import resolve_device

_NESTED = {"cars": CarState, "track": Track, "contacts": ContactState, "skid": SkidState,
           "man": Manifolds}


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


def track_from_numpy(tree, device=None) -> Track:
    """A batched (or pooled) port ``Track`` on ``device`` (default CUDA) from a
    field-name tree of numpy arrays, track axis first."""
    return _from_tree(Track, tree, resolve_device(device))


def track_to_numpy(track: Track) -> dict:
    """The port's ``Track`` as a dict of field name to numpy array."""
    return _to_tree(track)


def cars_from_numpy(tree, device=None) -> CarState:
    """A batched port ``CarState`` from a field-name tree of numpy arrays."""
    return _from_tree(CarState, tree, resolve_device(device))


def bundle_from_numpy(tree, device=None) -> ContactBundle:
    """A batched port ``ContactBundle`` (with its ``Manifolds``) on ``device``
    (default CUDA) from a field-name tree of numpy arrays, env axis first:
    the JAX package's ``collide.ContactBundle`` after ``jax.device_get``, so
    both sides can solve from the same manifolds."""
    return _from_tree(ContactBundle, tree, resolve_device(device))


def _policy_layers(net) -> list:
    """(flax module path, torch layer, kind) of each layer of an ``ActorCritic``,
    kind 'dense' (flax kernel (in, out)) or 'conv' (flax kernel HWIO)."""
    if net.obs_type == "state":
        torso = [(("StateTorso_0", "Dense_0"), net.torso.fc0, "dense"),
                 (("StateTorso_0", "Dense_1"), net.torso.fc1, "dense")]
    else:
        torso = [(("PixelTorso_0", f"Conv_{i}"), conv, "conv")
                 for i, conv in enumerate(net.torso.convs)]
        torso.append((("PixelTorso_0", "Dense_0"), net.torso.fc, "dense"))
    return torso + [(("Dense_0",), net.mean_head, "dense"), (("Dense_1",), net.value_head, "dense")]


def _kernel_to_torch(kernel: np.ndarray, kind: str) -> np.ndarray:
    # Dense (in, out) -> (out, in); Conv HWIO -> OIHW.
    return kernel.T if kind == "dense" else kernel.transpose(3, 2, 0, 1)


def _kernel_to_flax(weight: np.ndarray, kind: str) -> np.ndarray:
    return weight.T if kind == "dense" else weight.transpose(2, 3, 1, 0)


def _load(param: torch.Tensor, value, name: str) -> None:
    value = np.array(value, np.float32)          # a writable copy
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"policy_from_numpy: {name} has shape {value.shape}, the "
                         f"configured network expects {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def policy_from_numpy(params, obs_rms=None, *, obs_type: str, width: int, frame_stack: int,
                      device=None):
    """An ``ActorCritic`` on ``device`` (default CUDA) from flax's variables dict
    as numpy arrays, ``{"params": {"StateTorso_0" | "PixelTorso_0": ...,
    "Dense_0": ..., "Dense_1": ..., "log_std": ...}}``, and the ``obs_rms``
    dict (mean, var, count) as tensors on that device, or None.

    Dense kernels go (in, out) -> (out, in), conv kernels HWIO -> OIHW; every
    shape is checked against the configured network and a mismatch raises."""
    from .learner.networks import ActorCritic

    dev = resolve_device(device)
    net = ActorCritic(obs_type=obs_type, width=width, frame_stack=frame_stack)
    tree = params["params"]
    for path, layer, kind in _policy_layers(net):
        node = tree
        for key in path:
            node = node[key]
        name = "/".join(path)
        _load(layer.weight, _kernel_to_torch(np.asarray(node["kernel"]), kind), name + "/kernel")
        _load(layer.bias, node["bias"], name + "/bias")
    _load(net.log_std, tree["log_std"], "log_std")
    rms = None if obs_rms is None else {
        k: torch.as_tensor(np.asarray(obs_rms[k], np.float32), device=dev)
        for k in ("mean", "var", "count")}
    return net.to(dev), rms


def policy_to_numpy(net, obs_rms=None):
    """The inverse of ``policy_from_numpy``: (flax variables dict, obs_rms dict
    or None) as numpy float32 arrays."""
    tree: dict = {}
    for path, layer, kind in _policy_layers(net):
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel"] = _kernel_to_flax(layer.weight.detach().cpu().numpy(), kind)
        node["bias"] = layer.bias.detach().cpu().numpy()
    tree["log_std"] = net.log_std.detach().cpu().numpy()
    rms = None if obs_rms is None else {k: v.detach().cpu().numpy() for k, v in obs_rms.items()}
    return {"params": tree}, rms
