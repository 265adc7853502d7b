# Frozen copy of multi_car_racing_tpu_torch/seeding.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""RNG seeding with the reference's exact two-stream split.

The reference (see SURVEY.md §2.14) consumes randomness from two places:

1. ``env.seed(s)`` builds ``self.np_random`` through gym 0.17's
   ``gym.utils.seeding.np_random`` — a ``numpy.random.RandomState`` (MT19937)
   whose actual seed is derived via a sha512-based ``create_seed``/``hash_seed``
   chain (mcr:169-171).  That stream feeds ONLY the track generator's uniform
   draws (mcr:189-190), including on rejection retries.

2. Episode direction and car spawn order use the **global** ``np.random``
   (mcr:157, 352, 356) — deliberately not the env seed.

This module reimplements the gym 0.17.2 derivation chain so that the host
track generator is bit-identical to the reference, and exposes an explicit,
seedable stand-in for the global stream. It is a copy of the JAX package's
``seeding.py``: the PyTorch port imports nothing of that package.

Note: the gym 0.17.2 chain is reimplemented from its documented behavior
(sha512 of ``str(seed)``, 8-byte little-endian bigint, split into uint32
words for ``RandomState.seed``).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np


def _bigint_from_bytes(bt: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(bt) % sizeof_int
    bt += b"\0" * padding
    int_count = len(bt) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bt)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int) -> list[int]:
    if bigint < 0:
        raise ValueError("seed must be non-negative")
    if bigint == 0:
        return [0]
    ints: list[int] = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2**32)
        ints.append(mod)
    return ints


def create_seed(a: int | str | None = None, max_bytes: int = 8) -> int:
    """gym 0.17.2 ``seeding.create_seed``."""
    import os

    if a is None:
        return _bigint_from_bytes(os.urandom(max_bytes))
    if isinstance(a, str):
        bt = a.encode("utf8")
        bt += hashlib.sha512(bt).digest()
        return _bigint_from_bytes(bt[:max_bytes])
    if isinstance(a, int):
        return a % 2 ** (8 * max_bytes)
    raise TypeError(f"invalid seed type: {type(a)}")


def hash_seed(seed: int | None = None, max_bytes: int = 8) -> int:
    """gym 0.17.2 ``seeding.hash_seed``: sha512(str(seed)) truncated."""
    if seed is None:
        seed = create_seed(max_bytes=max_bytes)
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def np_random(seed: int | None = None) -> tuple[np.random.RandomState, int]:
    """gym 0.17.2 ``seeding.np_random``: hash-seeded MT19937 RandomState."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative integer, got {seed!r}")
    seed = create_seed(seed)
    rng = np.random.RandomState()
    rng.seed(_int_list_from_bigint(hash_seed(seed)))
    return rng, seed


class GlobalStream:
    """Seedable stand-in for the reference's module-global ``np.random`` usage.

    The reference draws (in order, per reset):
      - ``np.random.choice(['CW','CCW'])``  (mcr:352; also once in __init__, mcr:157)
      - ``np.random.choice(ids, size=num_agents, replace=False)``  (mcr:356)

    Wrapping a real ``RandomState`` and issuing the *same method calls* keeps
    the draw-for-draw bitstream consumption identical to the reference when the
    oracle harness seeds ``np.random`` with the same seed.
    """

    def __init__(self, seed: int | None = None):
        self.rs = np.random.RandomState(seed)

    def direction(self) -> str:
        return str(self.rs.choice(["CW", "CCW"]))

    def car_order(self, num_agents: int) -> np.ndarray:
        ids = [i for i in range(num_agents)]
        return self.rs.choice(ids, size=num_agents, replace=False)
