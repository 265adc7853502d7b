#!/usr/bin/env python3
"""One evaluation episode of a committed policy, in the JAX package and in
the PyTorch port, on the CPU, from the same reset state.

    python scripts/compare_eval_episode.py carracing_v0_solved 3561214485

The track seed names a host-track episode: the port resets it
(``env.reset_batch`` of that one seed) and both packages run their own
evaluation from that state: JAX's ``learner/evaluate.make_eval_fn``,
unchanged, reads it through a stand-in for its ``env.device_reset``; the
port's ``make_eval_fn`` runs its plain PyTorch path. The full 180/60 solver and 1000-step limit: the port's CPU
island takes ~3 min for one CarRacing-v0 episode, ~10 min at N = 2.
Prints each side's returns, tiles visited, track tiles and length.

This script imports JAX; the port does not.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(name: str, track_seed: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from multi_car_racing_tpu import config as JC, env as jenv
    from multi_car_racing_tpu.learner import evaluate as jeval, ppo as jppo
    from multi_car_racing_tpu_torch import convert, env as penv
    from multi_car_racing_tpu_torch.learner import evaluate, ppo
    from test_torch_obs import jax_state

    net, rms, cfg, flags, _ = evaluate.load_policy(name, "cpu")
    state = penv.reset_batch(cfg, [track_seed], 1, device="cpu")
    host = jax_state(convert.env_state_to_numpy(state))
    jenv.device_reset = lambda c, k: jax.tree_util.tree_map(lambda x: x[0], host)
    jcfg = JC.EnvConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, solver="xla")
    params, obs_rms = evaluate.read_policy_file(os.path.join(evaluate.POLICY_DIR, f"{name}.npz"))
    jrms = (None if not flags["normalize_obs"]
            else {k: jnp.asarray(v) for k, v in obs_rms.items()})
    for label, run in (
            ("JAX", lambda: jax.device_get(jeval.make_eval_fn(
                jcfg, jppo.PPOConfig(num_envs=1, **flags), 1)(params, jrms,
                                                             jax.random.PRNGKey(0)))),
            ("port", lambda: evaluate.make_eval_fn(
                cfg, ppo.PPOConfig(num_envs=1, **flags), 1)(net, rms, state))):
        t0 = time.perf_counter()
        out = run()
        out = {k: np.asarray(v).tolist() for k, v in out.items()}
        print(f"{label} {name} track seed {track_seed}: returns {out['returns']}, tiles "
              f"{out['tiles']} of {out['n_tiles']}, length {out['length']} "
              f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
