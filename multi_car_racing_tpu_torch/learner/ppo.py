"""PPO over batched envs, port of the JAX package's ``learner/ppo.py``.

One training step is a T-step rollout of E lockstep envs (``env.step``, the
state or pixel observation on every policy step, frame stacking, action
repeat, the training-only shaping costs), GAE, and ``epochs`` x
``minibatches`` clipped-surrogate updates, then the autoreset of finished
envs from a pool of tracks generated on the device (``init_train_state``).
Where the JAX version is one jitted function over a ``TrainState`` pytree,
this one is eager PyTorch on the state's device: the env stages run the
port's CUDA kernels, the network and the updates are plain torch ops
(cuDNN's bf16 convolutions for the pixel torso), and nothing waits for the
card until the caller reads a metric.

The optimizer is optax's ``chain(clip_by_global_norm, adam(schedule))``
written out (``ClippedAdam``). A minibatch whose loss or gradient norm is
not finite, or that comes after the KL early stop, leaves the parameters
and the optimizer state untouched, selected on the card as in JAX.

Data parallelism (``world``, a ``parallel.mesh.World``), as the JAX
package's mesh: each rank holds a contiguous range of the env rows and
computes what one process computes on the global batch. Every rank draws
the global numbers from the same generator state (the action noise, each
epoch's permutation of all B samples, the autoreset's draws) and keeps its
rows; each global minibatch is the members of the permutation's slice that
fall in the rank's rows, and the mask sum, the advantage mean and spread,
the gradients, the statistics, ``obs_rms`` and the metrics are summed (or
maxed) over the ranks. So every rank applies the same updates, and the
parameters, the optimizer and the generator stay identical. Without a
world (or in one without a process group) no collective runs.

With ``MCR_PPO_DEBUG_STATS`` set in the environment, the train step
returns the unreduced (epochs, minibatches) statistics under JAX's keys
(``stats_loss``, ``stats_pg``, ``stats_v``, ``stats_dlogp``, ``stats_kl``,
``stats_gn``) in place of the metrics, for NaN forensics.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from .. import config as C
from .. import env as penv
from .. import obs as pobs
from ..parallel.mesh import World
from ..util import resolve_device, tree_map
from .networks import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_len: int = 64
    num_envs: int = 256
    pool_size: int = 32
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    minibatches: int = 8
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    obs_type: str = "state"       # 'state' | 'pixels'
    # Each policy action is held for R env steps (rewards summed).
    action_repeat: int = 1
    normalize_obs: bool = False   # running mean/var over state features
    anneal_lr: bool = False       # linear lr -> 0 over total_updates
    total_updates: int = 1000
    width: int = 256              # state-torso width
    # Training-only reward shaping; evaluation scores the real env return.
    train_step_cost: float = 0.0  # extra cost per env step (pace)
    train_grass_cost: float = 0.0  # cost per car-step on grass
    # KL early stop (0 disables): once a minibatch's approximate KL exceeds
    # this, the remaining minibatch updates of the train step are skipped.
    kl_target: float = 0.0
    # tanh-squashed action head with the exact log-det correction, instead
    # of clipping the raw Gaussian into the action box.
    squash_actions: bool = False
    # Potential-based shaping on skipped tiles: phi(s) = -c * skipped(s).
    train_skip_cost: float = 0.0
    # Pace curriculum: ramp train_step_cost in from update `start` over
    # `ramp` updates.
    train_step_cost_start: int = 0
    train_step_cost_ramp: int = 1
    # Frame stacking (pixels only): the last K policy-step frames,
    # channel-stacked (96, 96, 3K), zero-filled at episode start.
    frame_stack: int = 1


def _rms_init(dim: int, device=None) -> dict:
    dev = resolve_device(device)
    return dict(mean=torch.zeros(dim, device=dev), var=torch.ones(dim, device=dev),
                count=torch.tensor(1e-4, device=dev))


def _rms_normalize(rms: dict, obs: torch.Tensor) -> torch.Tensor:
    return torch.clamp((obs - rms["mean"]) / torch.sqrt(rms["var"] + 1e-8), -10.0, 10.0)


def _rms_update(rms: dict, batch: torch.Tensor, mask: torch.Tensor | None = None,
                world: World = World()) -> dict:
    """Chan et al. parallel-variance merge of a new batch (..., D).

    ``mask`` (batch.shape[:-1]) excludes samples: masked rows are zeroed
    (they can be NaN), and an all-masked batch leaves ``rms`` as it is.
    With a mask, the batch is every rank's of ``world``: its masked count,
    mean and variance are summed over the ranks."""
    x = batch.reshape(-1, batch.shape[-1]).float()
    if mask is not None:
        mw = mask.reshape(-1).float()[:, None]
        x = torch.where(mw > 0, x, 0.0)
        count = world.sum(mw.sum())
        bc = torch.clamp(count, min=1.0)
        bm = world.sum((x * mw).sum(0)) / bc
        bv = world.sum((torch.square(x - bm) * mw).sum(0)) / bc
    else:
        bc = torch.tensor(float(x.shape[0]), device=x.device)
        bm, bv = x.mean(0), x.var(0, unbiased=False)
    delta = bm - rms["mean"]
    tot = rms["count"] + bc
    new_mean = rms["mean"] + delta * bc / tot
    m2 = rms["var"] * rms["count"] + bv * bc + torch.square(delta) * rms["count"] * bc / tot
    merged = dict(mean=new_mean, var=m2 / tot, count=tot)
    if mask is not None:
        keep = count > 0
        merged = {k: torch.where(keep, merged[k], rms[k]) for k in merged}
    return merged


def _skipped_tiles(env_state) -> torch.Tensor:
    """Per-car count of skipped tiles: unvisited valid tiles outside the
    largest circular unvisited run (the not-yet-reached arc). (E, N) f32."""
    u = (~env_state.visited) & env_state.track.valid[:, None, :]     # (E, N, MT)
    mt = u.shape[-1]
    idx = torch.arange(mt, dtype=torch.int32, device=u.device)
    # Linear run length ending at i: i - (last index j <= i with u_j False).
    last_false = torch.cummax(torch.where(u, -1, idx), dim=-1).values
    run = torch.where(u, idx - last_false, 0)
    longest_lin = run.max(-1).values
    # Circular wrap: the run from tile 0 plus the run ending at tile n-1.
    head = torch.cumprod(u.int(), dim=-1).sum(-1)
    n1 = torch.clamp(env_state.track.n_tiles.long() - 1, min=0)
    tail = torch.gather(run, 2, n1[:, None, None].expand(-1, u.shape[1], 1))[..., 0]
    total = u.sum(-1)
    longest = torch.minimum(torch.maximum(longest_lin, head + tail), total)
    return (total - longest).float()


def _observe(env_cfg, ppo_cfg: PPOConfig, env_state) -> torch.Tensor:
    if ppo_cfg.obs_type == "state":
        return pobs.state_observation(env_state)                  # (E, N, D)
    return pobs.pixel_observation_batched(env_cfg, env_state)     # (E, N, 96, 96, 3)


def _uses_stack(ppo_cfg: PPOConfig) -> bool:
    return ppo_cfg.obs_type == "pixels" and ppo_cfg.frame_stack > 1


def _stack_obs(frames, cur: torch.Tensor) -> torch.Tensor:
    """Stacked observation: previous K-1 frames (oldest first) + current."""
    return cur if frames is None else torch.cat([frames, cur], dim=-1)


def _push_frames(frames, cur: torch.Tensor):
    """Shift the stacking buffer: drop the oldest frame, append ``cur``."""
    if frames is None:
        return None
    return torch.cat([frames, cur], dim=-1)[..., cur.shape[-1]:]


def init_frames(ppo_cfg: PPOConfig, dummy_obs: torch.Tensor):
    """Zero-filled stacking buffer matching ``dummy_obs`` (E, N, H, W, 3)."""
    if not _uses_stack(ppo_cfg):
        return None
    k1 = ppo_cfg.frame_stack - 1
    return dummy_obs.new_zeros(dummy_obs.shape[:-1] + (dummy_obs.shape[-1] * k1,))


def _logp_gauss(mean, log_std, a):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * torch.square(a - mean) / var - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def squash_env_action(u: torch.Tensor) -> torch.Tensor:
    """Pre-squash sample u -> env action box (steer [-1,1], gas/brake [0,1])
    via tanh + affine."""
    t = torch.tanh(u)
    return torch.stack([t[..., 0], 0.5 * (t[..., 1] + 1.0), 0.5 * (t[..., 2] + 1.0)], dim=-1)


def clip_env_action(a: torch.Tensor) -> torch.Tensor:
    """The raw Gaussian action clipped into the env's box."""
    return torch.stack([torch.clamp(a[..., 0], -1, 1), torch.clamp(a[..., 1], 0, 1),
                        torch.clamp(a[..., 2], 0, 1)], dim=-1)


def _logp_squashed(mean, log_std, u):
    """log pi(a) for a = affine(tanh(u)), u the stored pre-squash sample;
    log(1 - tanh(u)^2) as 2 (log 2 - u - softplus(-2u)), the affine's
    constant log-det omitted (it cancels in PPO ratios)."""
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    corr = torch.sum(2.0 * (math.log(2.0) - u - softplus), dim=-1)
    return _logp_gauss(mean, log_std, u) - corr


class ClippedAdam:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), adam(lr))`` over a
    list of parameters, written out: the clip scales g by max_norm / |g|
    only when |g| >= max_norm (no epsilon); Adam with b1 0.9, b2 0.999, eps
    1e-8, eps_root 0 and bias correction; the constant or linear (to 0 over
    total_updates * epochs * minibatches) learning rate read at the count
    of applied updates. ``step(grads, ok)`` applies an update only where the
    0-d bool ``ok`` holds, selecting on the device, so a skipped minibatch
    leaves parameters, moments and the count untouched."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: list, cfg: PPOConfig):
        self.params = list(params)
        self.lr, self.max_norm = cfg.lr, cfg.max_grad_norm
        self.decay_steps = (cfg.total_updates * cfg.epochs * cfg.minibatches
                            if cfg.anneal_lr else 0)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    def learning_rate(self):
        """The step's learning rate: a float, or a 0-d tensor when annealed."""
        if not self.decay_steps:
            return self.lr
        count = torch.clamp(self.count, 0, self.decay_steps).float()
        return self.lr * (1 - count / self.decay_steps)

    @torch.no_grad()
    def step(self, grads: list, ok: torch.Tensor) -> None:
        grads = [torch.where(ok, g, 0.0) for g in grads]
        g_norm = global_norm(grads)
        clip = g_norm < self.max_norm
        grads = [torch.where(clip, g, (g / g_norm) * self.max_norm) for g in grads]
        count_inc = self.count + 1
        bc1 = 1 - self.B1 ** count_inc.float()
        bc2 = 1 - self.B2 ** count_inc.float()
        step_size = -self.learning_rate()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1 - self.B1) * g + self.B1 * mu
            nu_new = (1 - self.B2) * g ** 2 + self.B2 * nu
            update = step_size * ((mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.EPS))
            p.copy_(torch.where(ok, p + update, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
        self.count = torch.where(ok, count_inc, self.count)

    def state_dict(self) -> dict:
        return {"mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu],
                "count": self.count.clone()}

    def load_state_dict(self, state: dict) -> None:
        dev = self.params[0].device
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(state[key]) != len(dst):
                raise ValueError(f"ClippedAdam: {len(state[key])} {key} tensors for "
                                 f"{len(dst)} parameters")
            for d, s in zip(dst, state[key]):
                d.copy_(s.to(dev))
        self.count = state["count"].to(dev, torch.int32)


def global_norm(tensors: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


@dataclasses.dataclass
class TrainState:
    """The learner's whole state. ``net`` and ``opt`` are updated in place
    by ``train_step``; the other fields are replaced."""
    net: ActorCritic
    opt: ClippedAdam
    env_state: Any                # batched EnvState (E, ...)
    pool: Any                     # stacked Track (P, ...)
    generator: torch.Generator    # on the env state's device
    update_i: int
    env_cfg: C.EnvConfig
    ppo_cfg: PPOConfig
    obs_rms: dict | None = None   # mean, var, count | None
    frames: torch.Tensor | None = None   # (E, N, 96, 96, 3 * (K - 1)) uint8 | None


def derived_seeds(seed: int, count: int, stream: int) -> list[int]:
    """``count`` seeds drawn from ``seed``; ``stream`` keeps the training
    tracks' (0) apart from the evaluation episodes' (1)."""
    words = np.random.SeedSequence(seed, spawn_key=(stream,)).generate_state(count)
    return [int(w) for w in words]


def init_train_state(env_cfg: C.EnvConfig, ppo_cfg: PPOConfig, seed: int,
                     device=None, world: World = World()) -> TrainState:
    """A fresh learner on ``device`` (default CUDA).

    As in the JAX package (``ppo.py:227-232``), the tracks are generated on
    the device: the autoreset pool of ``pool_size`` tracks
    (``env.make_track_pool_checked``), then the first episodes
    (``env.device_reset``), both from a generator seeded from ``seed``
    (``derived_seeds`` stream 0). The state's own generator, seeded by
    ``seed``, draws the autoreset episodes. JAX draws with threefry: the
    distributions agree, the streams do not.

    Each rank of ``world`` generates the pool and all ``num_envs`` first
    episodes from the same seed and keeps its rows, as JAX's processes each
    hold their shard of one global reset; the network, seeded on the CPU,
    is the same on every rank (checked by a hash of its parameters)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    tracks = torch.Generator(device=dev).manual_seed(derived_seeds(seed, 1, 0)[0])
    pool = penv.make_track_pool_checked(env_cfg, tracks, ppo_cfg.pool_size)
    env_state = penv.device_reset(env_cfg, tracks, ppo_cfg.num_envs)
    if world.distributed:
        lo, hi = world.rows(ppo_cfg.num_envs)
        env_state = tree_map(lambda x: x[lo:hi].clone(), env_state)
    dummy_obs = _observe(env_cfg, ppo_cfg, env_state)
    net = ActorCritic(obs_type=ppo_cfg.obs_type, width=ppo_cfg.width,
                      frame_stack=ppo_cfg.frame_stack,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    if world.distributed:
        world.check_replicated(net.parameters(), "init_train_state: the network")
    use_rms = ppo_cfg.normalize_obs and ppo_cfg.obs_type == "state"
    return TrainState(
        net=net, opt=ClippedAdam(net.parameters(), ppo_cfg), env_state=env_state, pool=pool,
        generator=generator, update_i=0, env_cfg=env_cfg, ppo_cfg=ppo_cfg,
        obs_rms=_rms_init(dummy_obs.shape[-1], dev) if use_rms else None,
        frames=init_frames(ppo_cfg, dummy_obs),
    )


def make_train_step(env_cfg: C.EnvConfig, ppo_cfg: PPOConfig, world: World = World()):
    """Returns ``train_step(ts, draws=None) -> (ts, metrics)``, metrics a dict
    of 0-d tensors on the state's device, the same on every rank of
    ``world`` (whose ``ts`` holds its rows of the ``num_envs`` envs).

    ``draws`` replaces the state's generator as the source of the rollout's
    action noise (``draws["noise"]``, (T, E, N, 3) standard normals, one
    (E, N, 3) per policy step, all E envs on every rank) and of each epoch's
    permutation of the batch (``draws["perm"]``, (epochs, B) int64); the
    autoreset draws still come from the generator. On CUDA,
    ``train_step.marks`` holds the last call's stage-boundary events (read
    by ``stage_ms``)."""
    if ppo_cfg.action_repeat < 1:
        raise ValueError("action_repeat must be >= 1")
    T, E_all, N = ppo_cfg.rollout_len, ppo_cfg.num_envs, env_cfg.num_agents
    lo, hi = world.rows(E_all)
    E = hi - lo                   # this rank's env rows
    R = ppo_cfg.action_repeat
    max_steps = env_cfg.max_episode_steps
    use_rms = ppo_cfg.normalize_obs and ppo_cfg.obs_type == "state"
    B = T * E_all * N             # the global batch
    mb = B // ppo_cfg.minibatches
    grass_cost, skip_cost = ppo_cfg.train_grass_cost, ppo_cfg.train_skip_cost

    def env_step(es, a):
        """Physics fault containment: an env whose cars go nonfinite is
        marked done (out of the losses and the statistics, replaced by the
        autoreset) with its trip-step reward zeroed, and counted."""
        es, r, done = penv.step(env_cfg, es, a)
        bad = ~penv.finite_cars(es)
        es = es.replace(done=es.done | bad)
        r = torch.where(bad[:, None], 0.0, r)
        return es, r, done | bad, bad

    def policy(net, obs, noise):
        mean, log_std, value = net(obs)
        a = mean + torch.exp(log_std) * noise
        if ppo_cfg.squash_actions:
            return a, squash_env_action(a), _logp_squashed(mean, log_std, a), value
        return a, clip_env_action(a), _logp_gauss(mean, log_std, a), value

    def shaped(r, es, shape_cost):
        r = r - shape_cost
        if grass_cost:
            r = r - grass_cost * es.driving_on_grass.to(r.dtype)
        return r

    def phi(es):
        return -skip_cost * _skipped_tiles(es)                     # (E, N)

    def loss_and_grads(net, norm, mbatch, params):
        """This rank's share of the global minibatch's loss and its gradients:
        its samples' terms weighted over the global mask sum, the advantages
        normalised by the global mean and spread (the data-only sums, joined
        before the forward, on every rank). Returns (loss, (pg, v_loss,
        ratio_dev, dlogp_max, approx_kl), grads), each this rank's share (a
        max for dlogp_max); zeros on a rank that holds none of the samples."""
        live = mbatch["mask"] > 0
        w = mbatch["mask"] / torch.clamp(world.sum(mbatch["mask"].sum()), min=1.0)
        adv = torch.where(live, mbatch["adv"], 0.0)
        adv_mu = world.sum(torch.sum(adv * w))
        adv_sd = torch.sqrt(world.sum(torch.sum(torch.square(adv - adv_mu) * w)))
        adv = (adv - adv_mu) / (adv_sd + 1e-8)
        if not live.numel():
            zero = torch.zeros((), device=live.device)
            return zero, (zero,) * 5, [torch.zeros_like(p) for p in params]
        # Zero masked inputs, not only their weights: a masked obs can be
        # extreme or NaN, and 0 * inf in a backward is NaN.
        obs_live = live.reshape(live.shape + (1,) * (mbatch["obs"].dim() - 1))
        obs_safe = torch.where(obs_live, mbatch["obs"], torch.zeros((), dtype=mbatch["obs"].dtype,
                                                                    device=live.device))
        mean, log_std, value = net(norm(obs_safe))
        logp = (_logp_squashed if ppo_cfg.squash_actions else _logp_gauss)(
            mean, log_std, mbatch["action"])
        dlogp = torch.where(live, logp - mbatch["logp"], 0.0)
        ratio = torch.exp(dlogp)
        eps = ppo_cfg.clip_eps
        pg = -torch.sum(torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv) * w)
        v_clip = mbatch["value"] + torch.clamp(value - mbatch["value"], -eps, eps)
        v_err = torch.where(live, value - mbatch["ret"], 0.0)
        vc_err = torch.where(live, v_clip - mbatch["ret"], 0.0)
        v_loss = 0.5 * torch.sum(torch.maximum(torch.square(v_err), torch.square(vc_err)) * w)
        ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        # The mean over the global minibatch's mb rows: a rank holding them
        # all takes the mean, one holding some its share of the sum.
        ent = ent.mean() if ent.shape[0] == mb else ent.sum() / mb
        loss = pg + ppo_cfg.vf_coef * v_loss - ppo_cfg.ent_coef * ent
        # k3 approximate KL: dead samples contribute exactly 0.
        approx_kl = torch.sum((ratio - 1.0 - dlogp) * w)
        return loss, (pg, v_loss, torch.sum(torch.abs(ratio - 1) * w),
                      torch.max(torch.abs(dlogp)), approx_kl), torch.autograd.grad(loss, params)

    M = ppo_cfg.minibatches

    def minibatch_indices(perm: torch.Tensor) -> list:
        """Each global minibatch's members among this rank's rows, as indices
        into its flat (T, E, N) batch, in the permutation's order (one host
        read an epoch for the member counts)."""
        if not world.distributed:
            return [perm[i * mb:(i + 1) * mb] for i in range(M)]
        p = perm[:M * mb]
        t, e, n = p // (E_all * N), (p // N) % E_all, p % N
        own = (e >= lo) & (e < hi)
        local = ((t * E + (e - lo)) * N + n)[own]
        return list(torch.split(local, own.view(M, mb).sum(1).tolist()))

    def join_minibatch(loss, aux, grads):
        """The global minibatch's loss, statistics and gradients: the ranks'
        shares summed in one all-reduce (dlogp_max maxed in a second). The
        weights are global, so the sum of the shares' gradients is the
        gradient of the global loss."""
        if not world.distributed:
            return loss, aux, grads
        pg, v_loss, ratio_dev, dlogp_max, approx_kl = aux
        shares = torch.stack([loss, pg, v_loss, ratio_dev, approx_kl]).detach()
        flat = world.sum(torch.cat([g.reshape(-1) for g in grads] + [shares]))
        parts = torch.split(flat[:-5], [g.numel() for g in grads])
        grads = [f.view_as(g) for f, g in zip(parts, grads)]
        loss, pg, v_loss, ratio_dev, approx_kl = flat[-5:]
        return loss, (pg, v_loss, ratio_dev, world.max(dlogp_max.detach()), approx_kl), grads

    def train_step(ts: TrainState, draws: dict | None = None):
        net, gen = ts.net, ts.generator
        dev = ts.env_state.steps.device
        train_step.marks = []

        def mark(stage: str) -> None:
            if dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                train_step.marks.append((stage, ev))

        mark("start")

        def norm(obs):
            return _rms_normalize(ts.obs_rms, obs) if use_rms else obs

        if ppo_cfg.train_step_cost and ppo_cfg.train_step_cost_start > 0:
            frac = np.clip(np.float32(ts.update_i + 1 - ppo_cfg.train_step_cost_start)
                           / np.float32(max(ppo_cfg.train_step_cost_ramp, 1)), 0.0, 1.0)
            shape_cost = float(np.float32(ppo_cfg.train_step_cost) * np.float32(frac))
        else:
            shape_cost = ppo_cfg.train_step_cost

        env_state, frames = ts.env_state, ts.frames
        traj = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done", "fin",
                                "ret_snap", "alive", "nan_env")}
        for t in range(T):
            alive = penv.finite_cars(env_state) & ~penv.episode_over(env_cfg, env_state)
            obs_now = _observe(env_cfg, ppo_cfg, env_state)
            obs = _stack_obs(frames, obs_now)
            frames = _push_frames(frames, obs_now)
            noise = (draws["noise"][t] if draws is not None else
                     torch.randn((E_all, N, 3), generator=gen, device=dev))[lo:hi]
            with torch.no_grad():
                a, a_env, logp, value = policy(net, norm(obs), noise)
            if R == 1:
                if skip_cost:
                    phi0 = phi(env_state)
                env_state, r, done, bad = env_step(env_state, a_env)
                r = shaped(r, env_state, shape_cost)
                if skip_cost:
                    r = r + (ppo_cfg.gamma * phi(env_state) - phi0)
                r = r * alive.float()[:, None]
                fin = done | (env_state.steps >= max_steps)
                ret_snap = env_state.reward
            else:
                # Hold the action R steps and sum rewards; rewards after the
                # episode finished are masked out, and ret_snap freezes the
                # env's score at the step the episode finished.
                racc = torch.zeros((E, N), device=dev)
                fin, ret_snap = ~alive, env_state.reward
                phi_prev = phi(env_state) if skip_cost else None
                bad = torch.zeros((E,), dtype=torch.bool, device=dev)
                for _ in range(R):
                    env_state, r, done, bad_k = env_step(env_state, a_env)
                    r = shaped(r, env_state, shape_cost)
                    if skip_cost:
                        phi_new = phi(env_state)
                        r = r + (ppo_cfg.gamma * phi_new - phi_prev)
                        phi_prev = phi_new
                    live = 1.0 - fin.float()
                    racc = racc + r * live[:, None]
                    ret_snap = torch.where(fin[:, None], ret_snap, env_state.reward)
                    fin = fin | done | (env_state.steps >= max_steps)
                    bad = bad | bad_k
                r, done = racc, env_state.done
            for k, v in (("obs", obs), ("action", a), ("logp", logp), ("value", value),
                         ("reward", r), ("done", done[:, None].expand(E, N)), ("fin", fin),
                         ("ret_snap", ret_snap), ("alive", alive[:, None].expand(E, N)),
                         ("nan_env", bad)):
                traj[k].append(v)
        traj = {k: torch.stack(v) for k, v in traj.items()}
        mark("rollout")

        # Bootstrap + GAE, masked at dones. Values of quarantined envs' NaN
        # observations are zeroed first: nonterm = 0 does not neutralise
        # them inside the recursion (0 * NaN).
        with torch.no_grad():
            last_obs = _stack_obs(frames, _observe(env_cfg, ppo_cfg, env_state))
            _, _, last_value = net(norm(last_obs))
        last_value = torch.where(torch.isfinite(last_value), last_value, 0.0)
        values = torch.where(torch.isfinite(traj["value"]), traj["value"], 0.0)
        advs = torch.empty_like(values)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in reversed(range(T)):
            nonterm = 1.0 - traj["done"][t].float()
            delta = traj["reward"][t] + ppo_cfg.gamma * v_next * nonterm - values[t]
            adv_next = delta + ppo_cfg.gamma * ppo_cfg.gae_lambda * nonterm * adv_next
            advs[t], v_next = adv_next, values[t]
        returns = advs + values

        def flat(x):
            return x.reshape((T * E * N,) + x.shape[3:])

        batch = dict(obs=flat(traj["obs"]), action=flat(traj["action"]),
                     logp=flat(traj["logp"]), value=flat(values), adv=flat(advs),
                     ret=flat(returns), mask=flat(traj["alive"].float()))
        # Zero every masked sample once, wholesale: masked entries can be NaN
        # (a quarantined env) or extreme, and must reach neither the network
        # nor the weighted sums.
        live_b = batch["mask"] > 0
        batch = {k: (v if k == "mask" else torch.where(
            live_b.reshape(live_b.shape + (1,) * (v.dim() - 1)), v,
            torch.zeros((), dtype=v.dtype, device=dev))) for k, v in batch.items()}

        mark("gae")
        params = ts.opt.params
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        stats = []
        for ep in range(ppo_cfg.epochs):
            perm = (draws["perm"][ep] if draws is not None else
                    torch.randperm(B, generator=gen, device=dev)).to(dev)
            for idx in minibatch_indices(perm):
                loss, aux, grads = join_minibatch(*loss_and_grads(
                    net, norm, {k: v[idx] for k, v in batch.items()}, params))
                gn = global_norm(grads)
                ok = torch.isfinite(gn) & torch.isfinite(loss) & ~stopped
                ts.opt.step(grads, ok)
                if ppo_cfg.kl_target > 0:
                    stopped = stopped | (aux[-1].detach() > ppo_cfg.kl_target)
                stats.append(torch.stack([loss.detach(), *(x.detach() for x in aux), gn,
                                          1.0 - ok.float()]))
        stats = torch.stack(stats).T                                 # (8, epochs * mb)
        mark("update")

        # Episode returns: the env score snapshotted at the step each episode
        # finished (done or time limit).
        fin_t = traj["fin"]                                          # (T, E)
        finished = fin_t.any(0)
        tfirst = torch.argmax(fin_t.int(), dim=0)
        snap = traj["ret_snap"][tfirst, torch.arange(E, device=dev)]   # (E, N)
        snap = torch.where(torch.isfinite(snap), snap, 0.0)
        n_fin = world.sum(finished.sum())
        per_env_ret = snap.mean(-1)
        ep_return = torch.where(
            n_fin > 0, world.sum(torch.sum(torch.where(finished, per_env_ret, 0.0)))
            / torch.clamp(n_fin, min=1), 0.0)
        ep_return_max = torch.where(
            n_fin > 0, world.max(torch.max(torch.where(finished, per_env_ret, -torch.inf))),
            0.0)

        if frames is not None:
            # Envs about to be reset start their next episode with a
            # zero-filled stacking buffer, as in evaluation.
            needs = penv.episode_over(env_cfg, env_state)
            frames = torch.where(needs.reshape((E,) + (1,) * (frames.dim() - 1)),
                                 torch.zeros((), dtype=frames.dtype, device=dev), frames)
        # The autoreset draws every env's next episode, and this rank takes
        # its rows' (the generators stay in step).
        idx, orders, dirs = penv.draw_episodes(env_cfg, E_all, ts.pool.n_tiles.shape[0], gen)
        env_state = penv.reset_envs_from_pool(env_cfg, env_state, ts.pool, idx[lo:hi],
                                              orders[lo:hi], dirs[lo:hi])
        obs_rms = (_rms_update(ts.obs_rms, traj["obs"], traj["alive"], world) if use_rms
                   else None)

        mark("reset")
        new_ts = dataclasses.replace(ts, env_state=env_state, update_i=ts.update_i + 1,
                                     obs_rms=obs_rms, frames=frames)
        if os.environ.get("MCR_PPO_DEBUG_STATS"):
            st = stats.reshape(8, ppo_cfg.epochs, M)
            return new_ts, dict(stats_loss=st[0], stats_pg=st[1], stats_v=st[2],
                                stats_dlogp=st[4], stats_kl=st[5], stats_gn=st[6])
        metrics = dict(
            loss=stats[0].mean(), pg_loss=stats[1].mean(), v_loss=stats[2].mean(),
            ratio_dev=stats[3].mean(), dlogp_max=stats[4].max(),
            approx_kl_max=stats[5].max(), grad_norm_max=stats[6].max(),
            skipped_updates=stats[7].sum(),
            nan_envs=world.sum(traj["nan_env"].any(0).sum()).float(),
            mean_step_reward=world.mean(traj["reward"], E_all, dim=1),
            mean_value=world.mean(values, E_all, dim=1),
            ep_return=ep_return, ep_return_max=ep_return_max,
            episodes_finished=n_fin.float(),
        )
        return new_ts, metrics

    train_step.marks = []
    return train_step


def stage_ms(marks: list) -> dict:
    """Milliseconds of each stage of the last CUDA train step, from the
    events ``train_step.marks`` recorded at its boundaries: the rollout,
    GAE and the batch ("gae"), the minibatch updates, and the episode
    bookkeeping, autoreset and statistics ("reset"). Waits for the card."""
    if marks:
        marks[-1][1].synchronize()
    return {name: start.elapsed_time(end) for (_, start), (name, end) in zip(marks, marks[1:])}

