# Frozen copy of multi_car_racing_tpu_torch/util.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Small helpers shared by the port: device resolution and dataclass trees."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With no CUDA device present, only an explicit non-CUDA ``device`` (the
    tests pass ``"cpu"``) is accepted; the default raises instead of quietly
    running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


def tree_map(fn: Callable[..., Any], obj: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a (nested) dataclass, or to the leaves
    at the same place in ``obj`` and each tree of ``rest``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(obj)
        })
    return fn(obj, *rest)


def tree_leaves(obj: Any) -> list:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = []
        for f in dataclasses.fields(obj):
            out.extend(tree_leaves(getattr(obj, f.name)))
        return out
    return [obj]
