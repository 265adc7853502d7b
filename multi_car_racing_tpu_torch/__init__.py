"""multi_car_racing_tpu_torch — the PyTorch / CUDA port of multi_car_racing_tpu.

A package of its own beside the JAX one: it imports PyTorch, never JAX, and
nothing of ``multi_car_racing_tpu``. It steps E lockstep envs of
CarRacing-v0 (one car) or MultiCarRacing-v0 (``num_agents`` >= 2 cars, with
car-car contacts) on an NVIDIA card, through hand-written CUDA kernels: the
physics island (``csrc/joints_island.cu`` at one car per env,
``csrc/contact_island.cu`` at two or more) and the track stage
(``csrc/track_pass.cu``). It observes the envs as state vectors or as the
reference's 96x96 pixels (one launch of ``csrc/paint_view.cu`` per frame).
Tracks come from the host generator, bit-exact with the reference
(``reset_batch``, ``make_host_track_pool``), or are generated on the card
(``track/device.py``: ``device_reset``, ``make_track_pool_checked``), and
finished envs reset from a pool of either kind:

    from multi_car_racing_tpu_torch import EnvConfig, env, obs
    cfg = EnvConfig(num_agents=2)
    state = env.reset_batch(cfg, seeds=range(16), num_envs=4096)   # on CUDA
    state, reward, done = env.step(cfg, state, actions)            # (E, 2, 3)
    features = obs.state_observation(state)                         # (E, 2, 38)
    frames = obs.pixel_observation_batched(cfg, state)              # (E, 2, 96, 96, 3)
    g = torch.Generator("cuda").manual_seed(0)
    state = env.device_reset(cfg, g, num_envs=4096)                # tracks made on the card
    pool = env.make_track_pool_checked(cfg, g, pool_size=32)       # or make_host_track_pool
    state = env.reset_done_envs(cfg, state, pool, g)

The learner (``learner``: the actor-critic network, PPO and evaluation)
trains and evaluates policies on those envs, and ``checkpoint`` saves and
restores a learner mid-run. The four solved checkpoints of the JAX package
ship as policy files and evaluate by name:

    from multi_car_racing_tpu_torch.learner import evaluate, ppo
    net, obs_rms, env_cfg, flags, spec = evaluate.load_policy("pixels_solved")
    state = evaluate.episode_state(env_cfg, num_episodes=100, seed=7)
    out = evaluate.make_eval_fn(env_cfg, ppo.PPOConfig(num_envs=100, **flags), 100)(
        net, obs_rms, state)
    print(evaluate.summarize(out))
    ts = ppo.init_train_state(env_cfg, ppo.PPOConfig(num_envs=1024), seed=0)
    ts, metrics = ppo.make_train_step(env_cfg, ts.ppo_cfg)(ts)

The Gym facade is the reference's own entry point: one env, numpy in and
out, the 96x96 observation painted by the same kernel, ``render()`` with
the 600x400 ``rgb_array`` viewport and its skid trails
(``render.raster.render_observation``), and ``monitor.Monitor`` to record
episodes; ``train`` is the PPO command line, ``metrics`` its logger:

    import multi_car_racing_tpu_torch as mcr
    env = mcr.make("MultiCarRacing-v0")          # or "CarRacing-v0"; device="cpu"
    env.seed(0)
    obs = env.reset()                            # (2, 96, 96, 3) uint8
    obs, reward, done, info = env.step(env.action_space.sample())
    frames = env.render("rgb_array")             # (2, 400, 600, 3)
    env = mcr.monitor.Monitor(mcr.make("CarRacing-v0"), "/tmp/run1")
    # python -m multi_car_racing_tpu_torch.train --carracing-v0 --log run.jsonl

``VectorMultiCarRacing`` is the batched facade: E envs with autoreset, numpy
in and out, tracks generated on the card:

    venv = mcr.VectorMultiCarRacing(4096, num_agents=2, obs="pixels")  # "state", "none"
    obs = venv.reset()                                   # (4096, 2, 96, 96, 3)
    obs, rewards, dones, info = venv.step(actions)       # (4096, 2, 3)

Training scales over processes, one per card or several sharing one
(``parallel.mesh``: each rank steps its rows of the env batch, and the
ranks compute the one-process update on the global batch), and the demo
drives the facade with a track follower or from the keyboard in a terminal:

    # torchrun --nproc-per-node 4 -m multi_car_racing_tpu_torch.train -- --distributed
    # python -m multi_car_racing_tpu_torch.demo --steps 400 --out mcr.gif
    # python -m multi_car_racing_tpu_torch.demo --interactive

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain PyTorch version. Kernels build with
nvcc at first use; importing the package builds nothing.
"""

# The command lines (``train``, ``demo``, and ``tui`` behind ``demo
# --interactive``) load on first access (``__getattr__`` below), so that
# running one as a module finds it unloaded.
from . import (checkpoint, config, convert, env, gym_api, learner, metrics, monitor, obs,
               parallel, render, window)
from .config import EnvConfig
from .gym_api import MultiCarRacing, TimeLimit, VectorMultiCarRacing, make

__version__ = "0.1.0"
__all__ = ["checkpoint", "config", "convert", "demo", "env", "gym_api", "learner", "metrics",
           "monitor", "obs", "parallel", "render", "train", "tui", "window", "EnvConfig",
           "MultiCarRacing", "TimeLimit", "VectorMultiCarRacing", "make"]


def __getattr__(name: str):
    if name in ("demo", "train", "tui"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
