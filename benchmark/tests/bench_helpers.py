"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
4 envs, chunks of 4 decisions of 2 steps, 3 pool tracks, 30/12 solver
iterations and 20-step episodes: the spawn tick and the warm-up chunk take
9 steps, so chunk 1 ends in the reset where every first episode is over.

Besides the cells of ``BENCHMARK.json``, the tests drive two mixes that the
generator supports and later cells may use: a pixel observation, and both
cars on one line (``VARIANTS``)."""

import dataclasses

from benchmark.harness import loader

CHECK = {"envs": 3, "decisions": [[0, 4], [8, 12]], "resets": [0, 1]}
DECISIONS = 12           # the resets at chunks 0 and 1 and the check's decisions
VARIANTS = {
    "pixels": ("mcr2-state-lanes", {"observation": "pixels"}),
    "shared": ("mcr2-state-lanes", {"policy": {"name": "follower", "lanes": [0.0, 0.0],
                                               "max_speed": 40.0}}),
}


def tiny_cell(name: str) -> loader.Cell:
    """The cell ``name`` (or the variant of that name) cut to the tiny size."""
    base, changes = VARIANTS.get(name, (name, {}))
    cell = loader.cell(base)
    traffic = dict(cell.traffic, envs=4, rollout_len=4, action_repeat=2, pool_seeds=[5, 6, 7],
                   check=CHECK, **changes)
    env = dict(cell.config["env"], velocity_iters=30, position_iters=12,
               max_episode_steps=20)
    workload = dict(cell.workload, floors={})
    if traffic["observation"] == "pixels":
        limits = dict(workload["limits"])
        limits["pixel_share"] = limits.pop("obs_gap")
        workload["limits"] = limits
    return dataclasses.replace(cell, name=name, workload=workload, traffic=traffic,
                               config=dict(cell.config, env=env))
