"""Demo: drive the env and record frames, port of the JAX package's ``demo.py``
(the reference's demo loop, mcr:677-738).

The reference's demo is a pyglet keyboard loop; this one drives the Gym
facade (``gym_api.make``, on the card by default) with a built-in track
follower (or random actions), writes a GIF of one car's 96x96 view through
Pillow, and prints the per-car returns every 200 steps as the reference
loop does.

    python -m multi_car_racing_tpu_torch.demo --steps 400 --out mcr.gif
    python -m multi_car_racing_tpu_torch.demo --policy random --device cpu
    python -m multi_car_racing_tpu_torch.demo --interactive   # keyboard play (tui.py)

``--interactive`` needs only a TTY: the per-agent view renders as ANSI
truecolor half-blocks and arrows/WASD drive the cars with the reference's
bindings (``tui``).
"""

from __future__ import annotations

import argparse

import numpy as np

from . import gym_api
from . import obs as pobs


def heuristic_actions(env):
    """Simple track follower on the state features (``obs.state_observation``
    of the facade's one env): steer against the sine of the heading error
    (feature 16), a little gas, no brake. (num_agents, 3)."""
    f = pobs.state_observation(env.state)[0].cpu().numpy()
    err_sin = f[:, 16]
    steer = np.clip(-2.0 * err_sin, -1, 1)
    gas = np.full(env.num_agents, 0.3)
    brake = np.zeros(env.num_agents)
    return np.stack([steer, gas, brake], axis=-1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m multi_car_racing_tpu_torch.demo")
    ap.add_argument("--num-cars", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=["follow", "random"], default="follow")
    ap.add_argument("--out", default="multi_car_racing.gif")
    ap.add_argument("--view", type=int, default=0, help="agent view to record")
    ap.add_argument("--every", type=int, default=2, help="record every k frames")
    ap.add_argument("--interactive", action="store_true",
                    help="keyboard play in the terminal (ANSI rendering; "
                         "arrows car 0, WASD car 1 — see tui.py)")
    ap.add_argument("--monitor", default=None, metavar="DIR",
                    help="record per-episode mp4 + stats.json to DIR "
                         "(gym Monitor equivalent, mcr:714-717)")
    ap.add_argument("--window", action="store_true",
                    help="also flip frames to a live window each step "
                         "(needs a display; render('human'))")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.interactive:
        from . import tui

        total = tui.play(num_agents=args.num_cars, seed=args.seed, view=args.view,
                         every=args.every, device=args.device)
        print("final returns:", total)
        return total

    env = gym_api.make("MultiCarRacing-v0", num_agents=args.num_cars, verbose=1,
                       device=args.device)
    if args.monitor:
        from . import monitor

        env = monitor.Monitor(env, args.monitor, force=True)
    env.seed(args.seed)
    rng = np.random.RandomState(args.seed)

    env.reset()
    total_reward = np.zeros(args.num_cars)
    frames = []
    for step in range(args.steps):
        if args.policy == "follow":
            a = heuristic_actions(env)
        else:
            a = rng.uniform([-1, 0, 0], [1, 1, 0.2], size=(args.num_cars, 3))
        obs, r, done, info = env.step(a)
        total_reward += r
        if args.window:
            # Reference demo loop gates on render().all() (mcr:735).
            if not np.asarray(env.render("human")).all():
                break
        if step % args.every == 0:
            frames.append(obs[args.view])
        if step % 200 == 0 or done:
            print(f"Step {step} Total_reward {total_reward}")
        if done:
            break

    from PIL import Image

    imgs = [Image.fromarray(f).resize((192, 192), Image.NEAREST) for f in frames]
    imgs[0].save(args.out, save_all=True, append_images=imgs[1:], duration=40, loop=0)
    print(f"wrote {args.out} ({len(imgs)} frames)")
    env.close()
    return total_reward


if __name__ == "__main__":
    main()
