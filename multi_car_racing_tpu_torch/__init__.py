"""multi_car_racing_tpu_torch — the PyTorch / CUDA port of multi_car_racing_tpu.

A package of its own beside the JAX one: it imports PyTorch, never JAX, and
nothing of ``multi_car_racing_tpu``. It steps E lockstep envs of
CarRacing-v0 (one car) or MultiCarRacing-v0 (``num_agents`` >= 2 cars, with
car-car contacts) on an NVIDIA card, through hand-written CUDA kernels: the
physics island (``csrc/joints_island.cu`` at one car per env,
``csrc/contact_island.cu`` at two or more) and the track stage
(``csrc/track_pass.cu``). It observes the envs as state vectors or as the
reference's 96x96 pixels (one launch of ``csrc/paint_view.cu`` per frame),
and resets finished envs from a pool of host tracks:

    from multi_car_racing_tpu_torch import EnvConfig, env, obs
    cfg = EnvConfig(num_agents=2)
    state = env.reset_batch(cfg, seeds=range(16), num_envs=4096)   # on CUDA
    state, reward, done = env.step(cfg, state, actions)            # (E, 2, 3)
    features = obs.state_observation(state)                         # (E, 2, 38)
    frames = obs.pixel_observation_batched(cfg, state)              # (E, 2, 96, 96, 3)
    pool = env.make_track_pool(cfg, seeds=range(32))
    state = env.reset_done_envs(cfg, state, pool, torch.Generator("cuda"))

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

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain PyTorch version. Kernels build with
nvcc at first use; importing the package builds nothing.
"""

from . import checkpoint, config, convert, env, learner, obs, render
from .config import EnvConfig

__version__ = "0.1.0"
__all__ = ["checkpoint", "config", "convert", "env", "learner", "obs", "render", "EnvConfig"]
