#!/usr/bin/env python3
"""Whole episodes of the port held to the JAX package's own chaos floor.

The grid: seeds 100-131 (gseed = seed + 100, as ``scripts/chaos_floor.py``),
directions CCW and CW, 1,000 steps, and four rows of (cars, lanes): N = 1,
2 and 4 in the follower's lanes, and N = 2 on one shared line (lanes 0),
where the cars rear-end each other. Each row's 64 episodes run as one
batch of E = 64 envs in both packages.

Two legs:

    python scripts/torch_chaos_floor.py --leg jax   # the CPU; imports JAX
    python scripts/torch_chaos_floor.py --leg card  # an NVIDIA card; no JAX

``--leg jax`` runs the JAX package closed-loop under the follower
(``oracle/episodes.follower_action``) and records its actions; replays them
through JAX with car 0's hull nudged by 0.1 mm (JAX's own chaos floor), and
through the port's plain PyTorch path on the CPU. Each stage of each row
can run in a process of its own (``--rows``, ``--stage``) and writes a part
under ``--work``; ``--stage merge`` then writes ``actions.npz`` (the
recorded float32 actions, zero past each episode's end, and JAX's per-step
rewards) and ``jax_rows.jsonl`` into ``--out``.

``--leg card`` replays the committed actions through the port on the card,
without and with the nudge (the port's own floor), and runs the port
closed-loop with ``follower_actions``; it writes ``card_rows.jsonl`` and
prints the table of ``docs/PARITY.md`` §2 with the port in the engine's
place and JAX in the reference's. ``--leg table`` prints it from the files.

The bars (fixed before the runs):

- N = 1, open loop: median total drift from JAX <= 1e-3, and every
  episode's at most 2 * 1000 / n_tiles (two tile visits across a frame
  boundary);
- N >= 2, open loop: for each (N, direction, lanes) row, the port's mean
  drift from JAX over JAX's own nudge drift <= 3.0;
- closed loop: the two packages' mean total returns of a row's 64
  episodes within 2.58 * sqrt(s_jax^2 + s_port^2) / sqrt(64).

Total drift is |sum of the two runs' rewards| over their common steps,
summed over cars (``oracle/episodes.py``'s ``compare_episode`` in the JAX
package). Bootstrap 95% CIs of the means as ``scripts/chaos_floor.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS = {"n1": (1, None), "n2": (2, None), "n2_shared": (2, "shared"), "n4": (4, None)}
DIRECTIONS = ("CCW", "CW")
PERTURB = 1e-4
N1_MEDIAN_BAR = 1e-3
RATIO_BAR = 3.0
CLOSED_Z = 2.58
STEP_TOL = 2e-5                 # the per-step reward bar of the CPU tests


def grid(seeds: int) -> list:
    """The (seed, gseed, direction) of each env, CCW envs first."""
    return [(100 + s, 200 + s, d) for d in DIRECTIONS for s in range(seeds)]


def row_lanes(row: str):
    n, lanes = ROWS[row]
    return np.zeros(n) if lanes == "shared" else None


def bootstrap_ci(x, stat=np.mean, n=2000, seed=0):
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    vals = np.sort([stat(rng.choice(x, x.size, replace=True)) for _ in range(n)])
    return float(vals[int(0.025 * n)]), float(vals[int(0.975 * n)])


def compare(a_rew, a_len, b_rew, b_len) -> list:
    """Per-episode drift of run b from run a ((T, E, N) rewards, lengths),
    and the first step after the spawn tick at which a car's rewards differ
    by more than STEP_TOL (the episode's length if none)."""
    out = []
    for e in range(a_rew.shape[1]):
        L = int(min(a_len[e], b_len[e]))
        a, b = a_rew[:L, e].astype(np.float64), b_rew[:L, e].astype(np.float64)
        err = np.abs(a - b)
        apart = err[1:].max(-1) > STEP_TOL
        out.append(dict(total_drift=float(abs(a.sum() - b.sum())),
                        max_step_err_post0=float(err[1:].max()) if L > 1 else 0.0,
                        first_diff_step=int(apart.argmax()) + 1 if apart.any() else L))
    return out


def episode_fields(run: dict, e: int) -> dict:
    L = int(run["length"][e])
    return dict(ret=run["rewards"][:L, e].astype(np.float64).sum(0).tolist(),
                done_step=int(run["done_step"][e]), tiles=np.asarray(run["tiles"][e]).tolist(),
                contact_step=int(run["contact_step"][e]))


# --------------------------------------------------------------------------
# The JAX leg (CPU).
# --------------------------------------------------------------------------

def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_episodes(row: str, resets: list, actions=None, perturb: float = 0.0,
                 steps: int = 1000) -> dict:
    """One row's episodes in the JAX package, batched with vmap: closed-loop
    under its follower when ``actions`` is None, else a replay of them."""
    from functools import partial

    jax = _jax()
    import jax.numpy as jnp

    from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
    from multi_car_racing_tpu.oracle import episodes as jep
    from multi_car_racing_tpu.track import common as jcommon, host as jhost

    n = ROWS[row][0]
    lanes = row_lanes(row)
    cfg = JC.EnvConfig(num_agents=n)
    tracks, orders, dirs = [], [], []
    for seed, gseed, d in resets:
        orders.append(np.asarray(jseed.GlobalStream(gseed).car_order(n), np.int32))
        dirs.append(d == "CW")
        # The Python walk: the native one would build into the JAX package.
        pts, border, _ = jhost.generate_track(jseed.np_random(seed)[0])
        tracks.append(jcommon.pack_track(pts, border, max_tiles=cfg.max_tiles))
    track = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *tracks)
    state = jax.jit(jax.vmap(partial(jenv.reset_from_parts, cfg)))(
        track, jnp.asarray(np.stack(orders)), jnp.asarray(dirs))
    if perturb:
        state = state.replace(cars=state.cars.replace(
            hull_c=state.cars.hull_c.at[:, 0, 0].add(perturb)))
    step = jax.jit(jax.vmap(partial(jenv.step, cfg)))

    E = len(resets)
    nt = np.asarray(track.n_tiles)
    txy = [np.asarray(track.xy[e], np.float64)[:nt[e]] for e in range(E)]
    tbeta = [np.asarray(track.beta[e], np.float64)[:nt[e]] for e in range(E)]
    T = steps if actions is None else actions.shape[0]
    rewards = np.zeros((T, E, n), np.float32)
    dones = np.zeros((T, E), bool)
    contact = np.zeros((T, E), bool)
    acts = np.zeros((T, E, n, 3), np.float32)
    tiles = np.zeros((E, n), np.int32)
    ended = np.zeros(E, bool)
    for t in range(T):
        if actions is None:
            hc, hv, ha = (np.asarray(x, np.float64) for x in
                          (state.cars.hull_c, state.cars.hull_v, state.cars.hull_a))
            a = np.stack([jep.follower_action(
                txy[e], tbeta[e], dirs[e],
                [(hc[e, i], hv[e, i], float(ha[e, i])) for i in range(n)], lanes=lanes)
                for e in range(E)]).astype(np.float32)
        else:
            a = actions[t]
        state, r, d = step(state, jnp.asarray(a))
        rewards[t], d = np.asarray(r), np.asarray(d)
        dones[t] = d
        contact[t] = np.asarray((state.contacts.normal_imp > 0).any((1, 2)))
        acts[t] = np.where(ended[:, None, None], 0.0, a)
        cnt = np.asarray(state.tile_visited_count)
        tiles = np.where((d & ~ended)[:, None], cnt, tiles)
        ended |= d
    tiles = np.where(ended[:, None], tiles, np.asarray(state.tile_visited_count))
    done_step = np.where(dones.any(0), dones.argmax(0), T)
    length = np.minimum(done_step + 1, T)
    inside = np.arange(T)[:, None] < length[None]
    hit = contact & inside
    return dict(rewards=rewards * inside[..., None], done_step=done_step, length=length,
                tiles=tiles, n_tiles=nt, contact_step=np.where(hit.any(0), hit.argmax(0), -1),
                actions=acts)


def port_cpu_replay(row: str, resets: list, actions) -> dict:
    import torch

    from multi_car_racing_tpu_torch import EnvConfig
    from multi_car_racing_tpu_torch.oracle import episodes as ep

    torch.set_num_threads(1)
    return ep.run_episodes_open(EnvConfig(num_agents=ROWS[row][0]), resets, actions,
                                device="cpu")


def part_path(work: str, stage: str, row: str) -> str:
    return os.path.join(work, f"{stage}_{row}.npz")


def save_part(path: str, run: dict) -> None:
    np.savez_compressed(path, **{k: v for k, v in run.items()
                                 if k in ("rewards", "done_step", "length", "tiles", "n_tiles",
                                          "contact_step", "actions", "near")})


def jax_stage(stage: str, row: str, args) -> None:
    resets = grid(args.seeds)
    t0 = time.time()
    if stage == "closed":
        run = jax_episodes(row, resets, steps=args.steps)
    else:
        actions = np.load(part_path(args.work, "closed", row))["actions"]
        if stage == "nudge":
            run = jax_episodes(row, resets, actions, perturb=PERTURB)
        else:
            run = port_cpu_replay(row, resets, actions)
    save_part(part_path(args.work, stage, row), run)
    print(f"{row} {stage}: {len(resets)} episodes x {run['rewards'].shape[0]} steps in "
          f"{time.time() - t0:.1f} s", flush=True)


def jax_merge(args) -> None:
    arrays, lines = {}, []
    for row in args.rows:
        parts = {s: dict(np.load(part_path(args.work, s, row)))
                 for s in ("closed", "nudge", "cpu")}
        base = parts["closed"]
        arrays[f"actions_{row}"] = base["actions"]
        arrays[f"rewards_{row}"] = base["rewards"].astype(np.float32)
        arrays[f"length_{row}"] = base["length"]
        cmp = {s: compare(base["rewards"], base["length"], parts[s]["rewards"],
                          parts[s]["length"]) for s in ("nudge", "cpu")}
        for e, (seed, gseed, d) in enumerate(grid(args.seeds)):
            lines.append(dict(
                row=row, num_agents=ROWS[row][0], lanes=ROWS[row][1] or "follower", seed=seed,
                gseed=gseed, direction=d, n_tiles=int(base["n_tiles"][e]),
                jax=episode_fields(base, e),
                jax_nudge={**episode_fields(parts["nudge"], e), **cmp["nudge"][e]},
                port_cpu={**episode_fields(parts["cpu"], e), **cmp["cpu"][e]}))
    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(os.path.join(args.out, "actions.npz"), **arrays)
    with open(os.path.join(args.out, "jax_rows.jsonl"), "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    print(f"wrote {len(lines)} rows and the actions of {len(args.rows)} rows to {args.out}")


# --------------------------------------------------------------------------
# The card leg.
# --------------------------------------------------------------------------

def card_leg(args) -> None:
    import torch

    from multi_car_racing_tpu_torch import EnvConfig
    from multi_car_racing_tpu_torch.oracle import episodes as ep
    from multi_car_racing_tpu_torch.physics import fused_world, track_engine

    if not torch.cuda.is_available():
        raise SystemExit("torch_chaos_floor --leg card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    data = np.load(os.path.join(args.out, "actions.npz"))
    resets = grid(args.seeds)
    lines, launches = [], {}
    for row in args.rows:
        cfg = EnvConfig(num_agents=ROWS[row][0])
        actions = data[f"actions_{row}"]
        base = dict(rewards=data[f"rewards_{row}"], length=data[f"length_{row}"])
        runs, counts = {}, {}
        for name, run in (
                ("card", lambda: ep.run_episodes_open(cfg, resets, actions)),
                ("card_nudge", lambda: ep.run_episodes_open(cfg, resets, actions,
                                                            perturb=PERTURB)),
                ("card_closed", lambda: ep.run_episodes_closed(
                    cfg, resets, row_lanes(row), max_steps=actions.shape[0]))):
            fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
            track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
            t0 = time.perf_counter()
            runs[name] = run()
            torch.cuda.synchronize()
            counts[name] = dict(
                seconds=time.perf_counter() - t0, k1=fused_world.island_step.launches,
                k2=fused_world.island_step.contact_launches,
                k4_k5=track_engine.track_pass.launches,
                plain_track_calls=track_engine.track_pass_plain.cuda_calls,
                steps_with_near_env=int((runs[name]["near"] > 0).sum()))
            print(f"{row} {name}: {counts[name]}", flush=True)
        launches[row] = counts
        vs_jax = {s: compare(base["rewards"], base["length"], runs[s]["rewards"],
                             runs[s]["length"]) for s in ("card", "card_nudge")}
        own = compare(runs["card"]["rewards"], runs["card"]["length"],
                      runs["card_nudge"]["rewards"], runs["card_nudge"]["length"])
        for e, (seed, gseed, d) in enumerate(resets):
            lines.append(dict(
                row=row, num_agents=ROWS[row][0], lanes=ROWS[row][1] or "follower", seed=seed,
                gseed=gseed, direction=d, n_tiles=int(runs["card"]["n_tiles"][e]),
                card={**episode_fields(runs["card"], e), **vs_jax["card"][e]},
                card_nudge={**episode_fields(runs["card_nudge"], e),
                            **{f"{k}_vs_jax": v for k, v in vs_jax["card_nudge"][e].items()},
                            **own[e]},
                card_closed=episode_fields(runs["card_closed"], e)))
    os.makedirs(args.card_out, exist_ok=True)
    with open(os.path.join(args.card_out, "card_rows.jsonl"), "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    print(json.dumps({"card": smi, "launches": launches}), flush=True)
    ok = print_table(load_rows(os.path.join(args.out, "jax_rows.jsonl")), lines)
    if not ok:
        raise SystemExit("torch_chaos_floor: a bar failed")


# --------------------------------------------------------------------------
# The table and the bars.
# --------------------------------------------------------------------------

def load_rows(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _fmt_ci(x) -> str:
    lo, hi = bootstrap_ci(x)
    return f"{np.mean(x):.4g} [{lo:.4g}, {hi:.4g}]"


def print_table(jax_rows: list, card_rows: list) -> bool:
    """Print the open-loop and closed-loop tables; True if every bar held."""
    key = lambda r: (r["row"], r["seed"], r["direction"])     # noqa: E731
    card = {key(r): r for r in card_rows}
    ok = True
    print("\n## Open loop: drift from JAX's closed-loop run on its own actions, and JAX's own "
          f"floor (car 0 nudged {PERTURB:g} m)")
    print("| row | N | lanes | dir | JAX self drift mean [CI] | port CPU drift mean [CI] | ratio "
          "| port card drift mean [CI] | ratio | port's own floor (card) | contact episodes "
          "JAX / card | bar |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for row in ROWS:
        for d in DIRECTIONS:
            jr = [r for r in jax_rows if r["row"] == row and r["direction"] == d]
            if not jr:
                continue
            cr = [card[key(r)] for r in jr if key(r) in card]
            n = jr[0]["num_agents"]
            self_d = np.array([r["jax_nudge"]["total_drift"] for r in jr])
            drifts = {"cpu": np.array([r["port_cpu"]["total_drift"] for r in jr])}
            if cr:
                drifts["card"] = np.array([r["card"]["total_drift"] for r in cr])
            cells, verdict = {}, []
            for k, x in drifts.items():
                if n == 1:
                    limit = np.array([2000.0 / r["n_tiles"] for r in jr])
                    good = np.median(x) <= N1_MEDIAN_BAR and bool(np.all(x <= limit))
                    cells[k] = (f"{_fmt_ci(x)}, median {np.median(x):.3g}, max {x.max():.3g}",
                                "—")
                else:
                    ratio = x.mean() / max(self_d.mean(), 1e-9)
                    good = ratio <= RATIO_BAR
                    cells[k] = (_fmt_ci(x), f"{ratio:.2f}×")
                verdict.append(f"{k} {'met' if good else 'FAILED'}")
                ok &= good
            own = (_fmt_ci([r["card_nudge"]["total_drift"] for r in cr]) if cr
                   else "not run")
            contacts = (f"{sum(r['jax']['contact_step'] >= 0 for r in jr)} / "
                        + (str(sum(r['card']['contact_step'] >= 0 for r in cr)) if cr else "—"))
            card_cells = cells.get("card", ("not run", "—"))
            print(f"| {row} | {n} | {jr[0]['lanes']} | {d} | {_fmt_ci(self_d)} | "
                  f"{cells['cpu'][0]} | {cells['cpu'][1]} | {card_cells[0]} | {card_cells[1]} | "
                  f"{own} | {contacts} | {', '.join(verdict)} |")
    print("\n## Closed loop: total return per episode (sum over cars), 64 episodes a row")
    print("| row | N | lanes | JAX mean ± std | port (card) mean ± std | |diff| | bound "
          "| mean tiles/car JAX / port | contact episodes JAX / port | bar |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for row in ROWS:
        jr = [r for r in jax_rows if r["row"] == row]
        cr = [card[key(r)] for r in jr if key(r) in card]
        if not jr or not cr:
            continue
        a = np.array([sum(r["jax"]["ret"]) for r in jr])
        b = np.array([sum(r["card_closed"]["ret"]) for r in cr])
        bound = CLOSED_Z * np.sqrt(a.var() + b.var()) / np.sqrt(len(a))
        good = abs(a.mean() - b.mean()) <= bound
        ok &= good
        tiles_j = np.mean([np.mean(r["jax"]["tiles"]) for r in jr])
        tiles_p = np.mean([np.mean(r["card_closed"]["tiles"]) for r in cr])
        print(f"| {row} | {jr[0]['num_agents']} | {jr[0]['lanes']} | {a.mean():.2f} ± "
              f"{a.std():.2f} | {b.mean():.2f} ± {b.std():.2f} | {abs(a.mean() - b.mean()):.2f} | "
              f"{bound:.2f} | {tiles_j:.1f} / {tiles_p:.1f} | "
              f"{sum(r['jax']['contact_step'] >= 0 for r in jr)} / "
              f"{sum(r['card_closed']['contact_step'] >= 0 for r in cr)} | "
              f"{'met' if good else 'FAILED'} |")
    print("\n## When the runs part: the median first step at which a car's reward differs from "
          f"JAX's by more than {STEP_TOL:g} (32 episodes a row)")
    print("| row | dir | JAX nudged | port CPU | port card | port CPU earlier than JAX nudged |")
    print("|---|---|---|---|---|---|")
    for row in ROWS:
        for d in DIRECTIONS:
            jr = [r for r in jax_rows if r["row"] == row and r["direction"] == d]
            if not jr or "first_diff_step" not in jr[0]["jax_nudge"]:
                continue
            cr = [card[key(r)] for r in jr if key(r) in card]
            nud = np.array([r["jax_nudge"]["first_diff_step"] for r in jr])
            cpu = np.array([r["port_cpu"]["first_diff_step"] for r in jr])
            crd = [r["card"].get("first_diff_step") for r in cr]
            crd = f"{np.median(crd):g}" if crd and None not in crd else "not recorded"
            print(f"| {row} | {d} | {np.median(nud):g} | {np.median(cpu):g} | {crd} | "
                  f"{int((cpu < nud).sum())} of {len(jr)} |")
    print(f"\nevery bar met: {ok}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=("jax", "card", "table"), required=True)
    ap.add_argument("--stage", choices=("closed", "nudge", "cpu", "merge", "all"),
                    default="all", help="the JAX leg's stage (default: all, then merge)")
    ap.add_argument("--rows", nargs="+", choices=tuple(ROWS), default=list(ROWS))
    ap.add_argument("--seeds", type=int, default=32, help="seeds per direction")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "torch_parity"),
                    help="actions.npz and jax_rows.jsonl (written by the JAX leg)")
    ap.add_argument("--work", default=os.path.join(ROOT, "runs", "torch_parity"),
                    help="the JAX leg's parts, one file per stage and row")
    ap.add_argument("--card-out", default=None,
                    help="where the card leg writes card_rows.jsonl (default: --out)")
    args = ap.parse_args()
    args.card_out = args.card_out or args.out
    if args.leg == "card":
        card_leg(args)
    elif args.leg == "table":
        ok = print_table(load_rows(os.path.join(args.out, "jax_rows.jsonl")),
                         load_rows(os.path.join(args.out, "card_rows.jsonl")))
        return 0 if ok else 1
    else:
        os.makedirs(args.work, exist_ok=True)
        stages = ("closed", "nudge", "cpu") if args.stage == "all" else (args.stage,)
        for stage in stages:
            if stage != "merge":
                for row in args.rows:
                    jax_stage(stage, row, args)
        if args.stage in ("all", "merge"):
            jax_merge(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
