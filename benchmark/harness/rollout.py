"""The timed path: a batched rollout, the env side of a PPO train step.

One decision is: the policy stand-in reads the state; ``action_repeat``
calls of ``env.step`` with that action; the observation (the state vector or
the 96x96 pixel views); and the finite-cars test behind ``failed``. After
every ``rollout_len`` decisions comes ``env.reset_done_envs``, which puts
fresh episodes drawn from the track pool into the envs that are done or at
the time limit; it falls into the decision that ends the chunk. A CUDA event
ends each decision, so each decision's interval on the device is the time
between two of them.

Set-up makes the pool of host tracks from the traffic mix's track seeds
(one pool for every run, so every seed drives the same set of tracks and
the seed changes only which env drives which), draws the first episodes
from a ``torch.Generator`` on the card seeded by ``--seed``, runs the spawn tick, then one whole chunk and its reset as the
warm-up: every shape the window uses, and nothing else.

For the correctness check the rollout keeps copies of a sample of envs,
drawn from the seed, at a few decisions and resets (``Capture``): the
inputs the timed path was given and what it produced -- at a decision, the
state before and after one of its steps (drawn from the seed) with that
step's reward and done, and the state after the decision with its
observation; at a reset, the state before and after it with the
generator's state. Copying them is a
few index selects a sampled decision; nothing reads the card until the
window has closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from benchmark.harness import loader
from benchmark.reference import state_io

SPANS = ("policy", "env.step", "obs", "finite", "reset", "capture")


@dataclasses.dataclass
class Capture:
    """Copies of the sampled envs around one decision or reset."""

    kind: str                  # "start", "decision" or "reset"
    index: int                 # the decision (or, for "reset", the chunk)
    states: list = dataclasses.field(default_factory=list)   # trees, before and after
    step: int = 0              # the decision's step that is compared
    action: torch.Tensor | None = None
    rewards: list = dataclasses.field(default_factory=list)
    dones: list = dataclasses.field(default_factory=list)
    obs: torch.Tensor | None = None
    gen_state: torch.Tensor | None = None


class Rollout:
    """A cell's program state, policy and warm-up, and its decisions."""

    def __init__(self, cell: loader.Cell, seed: int, device: torch.device):
        from multi_car_racing_tpu_torch import EnvConfig
        from multi_car_racing_tpu_torch import env as penv
        from multi_car_racing_tpu_torch import obs as pobs

        self.penv, self.pobs = penv, pobs
        tr = cell.traffic
        self.cell, self.device = cell, device
        self.cfg = EnvConfig(**cell.config["env"])
        self.E, self.R = int(tr["envs"]), int(tr["action_repeat"])
        self.T = int(tr["rollout_len"])
        self.observation = tr["observation"]
        if self.observation not in ("state", "pixels"):
            raise ValueError(f"traffic {cell.workload['traffic']}: observation "
                             f"{self.observation!r} is neither 'state' nor 'pixels'")
        policy = tr["policy"]
        self.policy = loader.module("traffic", policy["name"]).make(
            policy, self.cfg.num_agents, device)
        self.track_seeds = [int(s) for s in tr["pool_seeds"]]
        self.P = len(self.track_seeds)

        # The check's sample, drawn from the seed.
        chk = tr["check"]
        rng = np.random.default_rng([seed % 2 ** 64, 1])
        k = min(int(chk["envs"]), self.E)
        self.sample = torch.as_tensor(np.sort(rng.choice(self.E, k, replace=False)),
                                      device=device)
        self.check_decisions = {int(rng.integers(a, b)): int(rng.integers(0, self.R))
                                for a, b in chk["decisions"]}
        self.check_resets = sorted(int(c) for c in chk["resets"])
        self.captures: list[Capture] = []
        self.span = lambda name: contextlib.nullcontext()

        self.pool = penv.make_host_track_pool(self.cfg, self.track_seeds, device=device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed % 2 ** 64)
        start = Capture("start", -1, gen_state=self.gen.get_state())
        idx, orders, dirs = penv.draw_episodes(self.cfg, self.E, self.P, self.gen)
        self.state = penv.episodes_from_pool(self.cfg, self.pool, idx, orders, dirs)
        start.states.append(self.take(self.state))
        self.captures.append(start)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.decisions = 0                    # decisions made in the window
        self.events: list = []

    # -- pieces of a decision ------------------------------------------------

    def take(self, state) -> dict:
        """The sampled envs of ``state`` as a tree of tensors (a copy)."""
        from multi_car_racing_tpu_torch.util import tree_map

        return state_io.tree(tree_map(lambda x: x.index_select(0, self.sample), state))

    def observe(self, state) -> torch.Tensor:
        if self.observation == "state":
            return self.pobs.state_observation(state)
        return self.pobs.pixel_observation_batched(self.cfg, state)

    def decision(self, capture: bool, capture_resets: bool = True) -> None:
        """One decision (and the chunk's reset when it ends a chunk); with
        ``capture``, the sampled envs around it are copied, and with
        ``capture_resets`` those around a checked reset."""
        penv, span = self.penv, self.span
        d, state = self.decisions, self.state
        cap = Capture("decision", d, step=self.check_decisions[d]) if capture else None
        with span("policy"):
            action = self.policy(state)
        if cap is not None:
            with span("capture"):
                cap.action = action.index_select(0, self.sample)
        for k in range(self.R):
            if cap is not None and k == cap.step:
                with span("capture"):
                    cap.states.append(self.take(state))
            with span("env.step"):
                state, reward, done = penv.step(self.cfg, state, action)
            if cap is not None and k == cap.step:
                with span("capture"):
                    cap.states.append(self.take(state))
                    cap.rewards.append(reward.index_select(0, self.sample))
                    cap.dones.append(done.index_select(0, self.sample))
        with span("obs"):
            obs = self.observe(state)
        if cap is not None:
            with span("capture"):
                cap.states.append(self.take(state))
                cap.obs = obs.index_select(0, self.sample)
                self.captures.append(cap)
        with span("finite"):
            self.bad += (~penv.finite_cars(state)).any()
        if (d + 1) % self.T == 0:
            chunk = d // self.T
            rcap = (Capture("reset", chunk) if capture_resets and chunk in self.check_resets
                    else None)
            if rcap is not None:
                with span("capture"):
                    rcap.states.append(self.take(state))
                    rcap.gen_state = self.gen.get_state()
            with span("reset"):
                state = penv.reset_done_envs(self.cfg, state, self.pool, self.gen)
            if rcap is not None:
                with span("capture"):
                    rcap.states.append(self.take(state))
                    self.captures.append(rcap)
        self.state = state
        self.decisions = d + 1

    def warm_up(self) -> None:
        """One whole chunk and its reset, uncaptured and uncounted."""
        for _ in range(self.T):
            self.decision(capture=False, capture_resets=False)
        self.decisions = 0
        self.bad.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------------

    def run_window(self, seconds: float, min_decisions: int = 0,
                   on_chunk=None) -> float:
        """Decisions back to back until ``seconds`` of host clock have passed
        (and at least ``min_decisions``), ended by a synchronize. Returns the
        window's seconds. ``on_chunk(c)`` runs before chunk ``c`` starts."""
        cuda = self.device.type == "cuda"
        if cuda:
            first = torch.cuda.Event(enable_timing=True)
            first.record()
            self.events = [first]
        t0 = time.perf_counter()
        while True:
            d = self.decisions
            if on_chunk is not None and d % self.T == 0:
                on_chunk(d // self.T)
            self.decision(capture=d in self.check_decisions)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            if self.decisions >= min_decisions and time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def decision_ms(self) -> list[float]:
        """Each decision's interval on the device (ms), after the window."""
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def p99(values: list[float]) -> float:
    """The 99th percentile by nearest rank: the smallest value with at least
    99% of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.99 * len(xs)) - 1)]
