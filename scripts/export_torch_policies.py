#!/usr/bin/env python3
"""Export the four committed PPO checkpoints to the PyTorch port's policy files.

    python scripts/export_torch_policies.py

Reads each slot of ``docs/runs/*_ckpt`` raw through orbax (no template: the
checkpoint's own tree) and writes its ``params`` leaves (flax's variables
dict) and its ``obs_rms`` leaves, when the run normalised observations, to
``multi_car_racing_tpu_torch/learner/policies/<name>.npz`` under their paths
in the checkpoint tree ("params/params/StateTorso_0/Dense_0/kernel",
"obs_rms/mean", ...),
uncompressed float32, bit for bit. It also writes ``policies.json``: for each
policy its slot, env preset, observation and learner flags, and the recorded
100-episode evaluation, each with the file and line it comes from.

This script imports JAX and orbax; the port that reads its output does not.
"""

from __future__ import annotations

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multi_car_racing_tpu_torch", "learner", "policies")

CARRACING_V0 = {"num_agents": 1, "use_random_direction": False, "backwards_flag": False}
STATE_FLAGS = {"obs_type": "state", "action_repeat": 4, "normalize_obs": True, "width": 512,
               "squash_actions": False, "frame_stack": 1}
PIXEL_FLAGS = {"obs_type": "pixels", "action_repeat": 4, "normalize_obs": False, "width": 256,
               "squash_actions": True, "frame_stack": 2}

POLICIES = {
    "carracing_v0_solved": {
        "slot": "docs/runs/carracing_v0_solved_ckpt.slot0",
        "env": CARRACING_V0, "env_source": "README.md:47-56 (--carracing-v0)",
        "ppo": STATE_FLAGS,
        "flags": "--carracing-v0 --action-repeat 4 --normalize-obs --width 512",
        "flags_source": "README.md:53-55; docs/PERF.md:304-306",
        "record": {"mean": 911.9, "std": 34.7, "episodes": 100, "seed": 7,
                   "source": "README.md:27; docs/PERF.md:299-306"},
    },
    "pixels_solved": {
        "slot": "docs/runs/pixels_solved_ckpt.slot0",
        "env": CARRACING_V0, "env_source": "docs/PERF.md:430, 438-441 (--carracing-v0)",
        "ppo": PIXEL_FLAGS,
        "flags": "--carracing-v0 --obs pixels --action-repeat 4 --squash-actions --frame-stack 2",
        "flags_source": "docs/PERF.md:438-441",
        "record": {"mean": 905.6400756835938, "std": 28.80600357055664, "episodes": 100,
                   "seed": 7, "source": "docs/runs/pixels_solved_eval100.log:1 (seed: "
                                        "docs/PERF.md:441)"},
    },
    "multi2p": {
        "slot": "docs/runs/multi2p_ckpt.slot0",
        "env": {"num_agents": 2}, "env_source": "docs/PERF.md:334-338 (--num-agents 2)",
        "ppo": STATE_FLAGS,
        "flags": "--num-agents 2 --action-repeat 4 --normalize-obs --width 512",
        "flags_source": "docs/PERF.md:334-338 (training flags)",
        "record": {"mean": 648.1, "std": 27.8, "episodes": 100, "seed": None,
                   "source": "README.md:65-67; docs/PERF.md:347-349"},
    },
    "multi2px": {
        "slot": "docs/runs/multi2px_ckpt.slot1",
        "env": {"num_agents": 2}, "env_source": "docs/PERF.md:378-384 (--num-agents 2)",
        "ppo": PIXEL_FLAGS,
        "flags": "--num-agents 2 --obs pixels --action-repeat 4 --squash-actions "
                 "--frame-stack 2",
        "flags_source": "docs/PERF.md:378-384 (training flags)",
        "record": {"mean": 603.4315185546875, "std": 67.54739379882812, "episodes": 100,
                   "seed": None, "source": "docs/runs/multi2px_eval100.log:1"},
    },
}


def flat_leaves(tree, prefix: str) -> dict:
    """{"prefix/a/b": array} over a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def restore_slot(slot: str) -> dict:
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer().restore(os.path.join(ROOT, slot))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    for name, spec in POLICIES.items():
        tree = restore_slot(spec["slot"])
        leaves = flat_leaves(tree["params"], "params")
        if tree.get("obs_rms") is not None:
            leaves.update(flat_leaves(tree["obs_rms"], "obs_rms"))
        for k, a in leaves.items():
            if a.dtype != np.float32:
                raise ValueError(f"{name}: {k} is {a.dtype}, not float32")
        np.savez(os.path.join(OUT, f"{name}.npz"), **leaves)
        print(f"{name}: {len(leaves)} leaves, "
              f"{sum(a.size for a in leaves.values()):,} floats")
    with open(os.path.join(OUT, "policies.json"), "w") as f:
        json.dump(POLICIES, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
