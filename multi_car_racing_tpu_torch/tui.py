"""Interactive terminal play, port of the JAX package's ``tui.py``: the
reference's keyboard demo (mcr:677-738) for hosts without a display.

The reference opens per-agent pyglet windows and binds arrows / WASD
(mcr:682-683, 711-713). A GPU host reached over SSH has no display, so this
renders the per-agent 96x96 observation (painted on the card by the facade)
as ANSI truecolor half-blocks (96 columns x 48 rows) and reads the same key
bindings from the raw terminal: arrows drive car 0, WASD car 1; Esc stops,
Enter restarts (mcr:689-690); brake applies 0.8 (mcr:696); the cumulative
per-car returns show on the status line.

Terminals report key *presses* (with autorepeat), not releases, so a key
counts as held for ``hold`` seconds after its last press — the one
documented divergence from the reference's press/release handlers.

    python -m multi_car_racing_tpu_torch.demo --interactive
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

# Key tokens.
UP, DOWN, LEFT, RIGHT = "UP", "DOWN", "LEFT", "RIGHT"
ESC, ENTER = "ESC", "ENTER"

# Reference bindings (mcr:682-683): car 0 arrows, car 1 WASD.
CAR_CONTROL_KEYS = [
    {LEFT: "steer_l", RIGHT: "steer_r", UP: "gas", DOWN: "brake"},
    {"a": "steer_l", "d": "steer_r", "w": "gas", "s": "brake"},
]


class _RawTerminal:
    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        sys.stdout.write("\x1b[?25l\x1b[2J")          # hide cursor, clear
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)
        sys.stdout.write("\x1b[?25h\x1b[0m\n")        # restore cursor
        sys.stdout.flush()


def _read_tokens():
    """Drain stdin, yielding key tokens (non-blocking)."""
    tokens = []
    while select.select([sys.stdin], [], [], 0)[0]:
        ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        if ch == "\x1b":
            if select.select([sys.stdin], [], [], 0.002)[0]:
                seq = os.read(sys.stdin.fileno(), 2).decode(errors="ignore")
                tokens.append(
                    {"[A": UP, "[B": DOWN, "[C": RIGHT, "[D": LEFT}.get(seq, "")
                )
            else:
                tokens.append(ESC)
        elif ch in ("\r", "\n"):
            tokens.append(ENTER)
        elif ch:
            tokens.append(ch.lower())
    return tokens


def frame_to_ansi(img: np.ndarray) -> str:
    """(H, W, 3) uint8 -> ANSI truecolor half-block string (H/2 rows)."""
    h, w, _ = img.shape
    if h % 2:
        img = img[: h - 1]
        h -= 1
    top = img[0::2]
    bot = img[1::2]
    out = []
    for r in range(h // 2):
        row = []
        last = None
        for c in range(w):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c]
            key = (tr, tg, tb, br, bg, bb)
            if key != last:
                row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m")
                last = key
            row.append("▀")
        row.append("\x1b[0m")
        out.append("".join(row))
    return "\n".join(out)


def actions_from_keys(held, num_agents, t_now):
    """Map currently-held keys to the (N, 3) action array."""
    a = np.zeros((num_agents, 3), np.float32)
    for car in range(min(num_agents, len(CAR_CONTROL_KEYS))):
        for key, ctrl in CAR_CONTROL_KEYS[car].items():
            if held.get(key, 0.0) > t_now:
                if ctrl == "steer_l":
                    a[car, 0] = -1.0
                elif ctrl == "steer_r":
                    a[car, 0] = +1.0
                elif ctrl == "gas":
                    a[car, 1] = 1.0
                elif ctrl == "brake":
                    a[car, 2] = 0.8        # mcr:696
    return a


def play(num_agents: int = 2, seed: int = 0, view: int = 0,
         hold: float = 0.2, every: int = 2, max_steps: int = 100000, device=None):
    """Run the interactive loop on ``device`` (default CUDA). Returns the
    final cumulative rewards."""
    from . import gym_api

    if not sys.stdin.isatty():
        raise RuntimeError(
            "interactive play needs a TTY (run from a terminal; use the "
            "scripted demo otherwise)"
        )

    env = gym_api.make("MultiCarRacing-v0", num_agents=num_agents, verbose=0, device=device)
    env.seed(seed)
    env.reset()
    total = np.zeros(num_agents)
    held: dict = {}
    step = 0
    dt = 1.0 / 50.0                                   # FPS=50 (mcr:44)

    header = (
        "arrows: car 0   WASD: car 1   Enter: restart   Esc: quit\n"
    )
    with _RawTerminal():
        t_next = time.time()
        while step < max_steps:
            now = time.time()
            for tok in _read_tokens():
                if tok == ESC:
                    return total
                if tok == ENTER:
                    env.reset()
                    total = np.zeros(num_agents)
                    step = 0
                    continue
                if tok:
                    held[tok] = now + hold

            a = actions_from_keys(held, num_agents, now)
            obs, r, done, _ = env.step(a)
            total += r
            step += 1

            if step % every == 0:
                frame = frame_to_ansi(np.asarray(obs[view]))
                sys.stdout.write("\x1b[H" + header + frame)
                sys.stdout.write(
                    f"\n\x1b[0mstep {step:5d}  return "
                    + " ".join(f"{x:8.2f}" for x in total)
                    + "   "
                )
                sys.stdout.flush()
            if done:
                env.reset()
                total = np.zeros(num_agents)
                step = 0

            t_next += dt
            pause = t_next - time.time()
            if pause > 0:
                time.sleep(pause)
            else:
                t_next = time.time()
    return total
