"""Whether the timed path's outputs are correct: the sampled envs' captures
against the plain reference (``benchmark/reference``).

The reference regenerates the track pool from the run's track seeds (the
Python walk and the float64 packing) and redraws every autoreset from the
generator's state at that reset. For a step it starts from the program's own
state before the step (the contact system of two or more cars is chaotic,
so only a step at a time can be followed) with its own tracks, and for an
observation from the program's state after the decision. The physics runs
on the CPU, one thread (its many small ops run faster there than launched
one by one on the card); the pixel observation's painter runs on the card.
What is compared:

- ``state_gap``: over every float leaf of the state after a step, a reset
  tick or the first spawn tick (cars, contact impulses, scores, time), the
  largest gap between the program's and the reference's value beyond
  ``ULPS`` float32 units in the last place of the larger of the two (the
  program's sines and cosines on the card and the reference's on the CPU
  differ by an ulp, and a coordinate of 300 m carries ulps of 3e-5 m),
  measured against the largest change the reference makes to that leaf in
  the step (at least ``STEP_FLOOR``); the worst over leaves and units;
- ``reward_gap``: the largest gap between step rewards;
- ``flag_share``: the share of compared (env, step) and (env, reset) pairs
  in which any discrete leaf differs (tile contacts, visits, counts, done,
  the backward and grass flags, joint limit states, contact ids);
- ``obs_gap`` (state observations): the largest gap of a feature;
  ``pixel_share`` (pixels): the share of observation bytes that differ;
- ``exact_mismatch``: leaves that must be equal bit for bit and are not --
  every captured track against the reference's track, and every env that a
  reset leaves alone against its state before the reset.

``control`` puts the reference itself in the program's place at the
nearest precision below the configuration's float32: bfloat16, to which it
rounds its state, tracks and actions on the way in and its results on the
way out (the arithmetic between runs in float32: the plain ops mix their
float32 constants into every product, and PyTorch's scatter-adds refuse
mixed types).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import config as RC
from benchmark.reference import env as renv
from benchmark.reference import obs as robs
from benchmark.reference import seeding, state_io
from benchmark.reference.track import common, host

STEP_FLOOR = 1e-3
ULPS = 4
NUMBERS = ("state_gap", "reward_gap", "flag_share", "obs_gap", "pixel_share",
           "exact_mismatch")
_SKIP = ("track", "skid")           # tracks are held exactly; trails are render-only
CPU = torch.device("cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _state_leaves(tree):
    return {k: v for k, v in _leaves(tree) if k.split(".")[0] not in _SKIP}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got - ref| elementwise, 0 where both are NaN, inf where one is."""
    d = (got.double() - ref.double()).abs()
    both = torch.isnan(got) & torch.isnan(ref)
    return torch.nan_to_num(torch.where(both, torch.zeros_like(d), d), nan=float("inf"))


def _bf16(obj):
    """Every float tensor of a tree rounded to bfloat16 and held in float32."""
    return state_io.cast(state_io.cast(obj, torch.bfloat16), torch.float32)


def reference_pool(cfg, seeds):
    arrays = []
    for s in seeds:
        pts, border, _ = host.generate_track(seeding.np_random(s)[0])
        arrays.append(common.pack_track_arrays(pts, border, cfg.max_tiles))
    return common.track_from_arrays(arrays, CPU)


def _track_rows(track, idx: torch.Tensor):
    return track.__class__(**{f.name: getattr(track, f.name).index_select(0, idx)
                              for f in dataclasses.fields(track)})


class Check:
    """Accumulates the compared numbers over a run's captures."""

    def __init__(self, env_config: dict, seeds, num_envs: int, pool_size: int,
                 sample: torch.Tensor, observation: str, card: torch.device,
                 control: bool = False):
        self.cfg = RC.EnvConfig(**env_config)
        renv.check_config(self.cfg)
        self.E, self.P, self.card = num_envs, pool_size, card
        self.sample = sample
        self.observation, self.control = observation, control
        self.pool = reference_pool(self.cfg, seeds)
        self.n = {k: 0.0 for k in NUMBERS}
        self.worst = {k: "" for k in NUMBERS}
        self.units = {"steps": 0, "env_steps": 0, "contact_env_steps": 0, "resets": 0,
                      "fresh_envs": 0, "kept_envs": 0, "obs": 0, "warm_views": 0}
        self._flags = [0, 0]
        self._pix = [0, 0]

    def _note(self, number: str, value: float, where: str) -> None:
        if value > self.n[number]:
            self.n[number], self.worst[number] = value, where

    def _own_tracks(self, tree: dict) -> dict:
        """The tree with each env's track replaced by the reference's pool
        track it equals bit for bit (a track that equals none counts in
        ``exact_mismatch`` and keeps the program's tables)."""
        got = tree["track"]
        ref = {f.name: getattr(self.pool, f.name) for f in dataclasses.fields(self.pool)}
        K = got["xy"].shape[0]
        match = torch.full((K,), -1, dtype=torch.int64)
        for k in range(K):
            for p in range(self.P):
                if all(torch.equal(got[name][k], ref[name][p]) for name in ref):
                    match[k] = p
                    break
        missing = int((match < 0).sum())
        self.n["exact_mismatch"] += missing
        if missing:
            self.worst["exact_mismatch"] += f" {missing} tracks;"
        ok = match >= 0
        own = {name: torch.where(ok.view((-1,) + (1,) * (v.dim() - 1)),
                                 v.index_select(0, match.clamp(min=0)), got[name])
               for name, v in ref.items()}
        return {**tree, "track": own}

    def _compare_state(self, got: dict, ref, pre: dict, where: str, envs=None) -> None:
        """state_gap over float leaves, and the per-env flag mismatches, of
        the envs ``envs`` (all when None)."""
        ref_l = _state_leaves(state_io.tree(ref))
        pre_l = _state_leaves(pre)
        flags = None
        for k, g in _state_leaves(got).items():
            r, p = ref_l[k], pre_l[k]
            if envs is not None:
                g, r, p = g[envs], r[envs], p[envs]
            if g.numel() == 0:
                continue
            if g.is_floating_point():
                scale = max(STEP_FLOOR, float(_gap(r, p).max()))
                ulps = ULPS * 2.0 ** -23 * torch.maximum(g.double().abs(), r.double().abs())
                gap = float((_gap(g, r) - torch.nan_to_num(ulps)).clamp(min=0).max())
                self._note("state_gap", gap / scale, f"{where} {k} ({gap:.3g} of {scale:.3g})")
            else:
                diff = (g != r).reshape(g.shape[0], -1).any(1)
                if bool(diff.any()):
                    self.worst["flag_share"] += f" {where} {k} x{int(diff.sum())};"
                flags = diff if flags is None else flags | diff
        if flags is not None:
            self._flags[0] += int(flags.sum())
            self._flags[1] += flags.numel()

    # -- units ---------------------------------------------------------------

    def fresh(self, got: dict, pre: dict | None, gen_state, where: str) -> None:
        """A reset (``pre`` the state before it) or the first episodes of
        set-up (``pre`` None): the draws from the generator's state, the
        spawn and spawn tick of the fresh envs, the others kept."""
        got = self._own_tracks(_to(got, CPU))
        g = torch.Generator(device=self.card)
        g.set_state(gen_state)
        draws = renv.draw_episodes(self.cfg, self.E, self.P, g)
        idx, orders, dirs = (x.index_select(0, self.sample.to(x.device)).to(CPU)
                             for x in draws)
        tracks = _track_rows(self.pool, idx)
        spawn = renv.spawn_state(self.cfg, tracks, orders, dirs)
        if self.control:
            fresh = _bf16(renv.reset_from_parts(self.cfg, _bf16(tracks), orders, dirs))
        else:
            fresh = renv.reset_from_parts(self.cfg, tracks, orders, dirs)
        K = self.sample.numel()
        if pre is None:
            needs = torch.ones(K, dtype=torch.bool)
        else:
            pre = _to(pre, CPU)
            needs = renv.episode_over(self.cfg, state_io.env_state(pre))
        fresh_envs, kept = needs.nonzero().flatten(), (~needs).nonzero().flatten()
        self._compare_state(got, fresh, state_io.tree(spawn), where, fresh_envs)
        if pre is not None and kept.numel():
            before = dict(_leaves(self._own_tracks(pre)))
            for k, v in _leaves(got):
                if not torch.equal(v[kept], before[k][kept]):
                    self.n["exact_mismatch"] += 1
                    self.worst["exact_mismatch"] += f" {where} kept {k};"
        self.units["resets"] += 1
        self.units["fresh_envs"] += fresh_envs.numel()
        self.units["kept_envs"] += kept.numel()

    def decision(self, cap) -> None:
        """The decision's sampled step, then its observation."""
        pre, got, post = (self._own_tracks(_to(s, CPU)) for s in cap.states)
        action = cap.action.to(CPU)
        where = f"decision {cap.index} step {cap.step}"
        ref, r_ref, d_ref = renv.step(self.cfg, state_io.env_state(pre), action)
        r_got, d_got = cap.rewards[0].to(CPU), cap.dones[0].to(CPU)
        if self.control:
            low, r_got, d_got = _bf16(renv.step(self.cfg, _bf16(state_io.env_state(pre)),
                                                _bf16(action)))
            got = state_io.tree(low)
        self._compare_state(got, ref, pre, where)
        self._note("reward_gap", float(_gap(r_got, r_ref).max()), where)
        done_diff = d_got != d_ref
        self._flags[0] += int(done_diff.sum())
        self.units["steps"] += 1
        self.units["env_steps"] += done_diff.numel()
        self.units["contact_env_steps"] += int(
            (got["contacts"]["normal_imp"].reshape(done_diff.shape[0], -1) != 0).any(1).sum())
        # The observation of the program's state after the decision.
        device = CPU if self.observation == "state" else self.card
        post = _to(post, device)
        ref_obs = self._observe(post, control=False)
        got_obs = self._observe(post, control=True) if self.control else cap.obs.to(device)
        if self.observation == "state":
            self._note("obs_gap", float(_gap(got_obs, ref_obs).max()), f"decision {cap.index}")
        else:
            diff = got_obs != ref_obs
            self._pix[0] += int(diff.sum())
            self._pix[1] += diff.numel()
            if bool(diff.any()):
                self.worst["pixel_share"] += f" decision {cap.index} x{int(diff.sum())};"
            from benchmark.reference.render import pixels
            warm = pixels._scene(self.cfg, state_io.env_state(post))["warm"] > 0
            self.units["warm_views"] += int(warm.sum())
        self.units["obs"] += 1

    def _observe(self, tree: dict, control: bool) -> torch.Tensor:
        st = state_io.env_state(tree)
        if control:
            st = _bf16(st)
        if self.observation == "state":
            out = robs.state_observation(st)
            return _bf16(out) if control else out
        return robs.pixel_observation(self.cfg, st)

    def numbers(self) -> dict:
        """The compared numbers (those of this cell's observation)."""
        out = dict(self.n)
        out["flag_share"] = self._flags[0] / max(1, self._flags[1])
        out["pixel_share"] = self._pix[0] / max(1, self._pix[1])
        out.pop("pixel_share" if self.observation == "state" else "obs_gap")
        return out
