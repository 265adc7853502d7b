"""multi_car_racing_tpu_torch — the PyTorch / CUDA port of multi_car_racing_tpu.

A package of its own beside the JAX one: it imports PyTorch, never JAX, and
nothing of ``multi_car_racing_tpu``. This slice steps E lockstep envs with
one car each (CarRacing-v0) on an NVIDIA card, the fused physics stage
running in the hand-written CUDA kernel ``csrc/joints_island.cu``:

    from multi_car_racing_tpu_torch import EnvConfig, env
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    state = env.reset_batch(cfg, seeds=range(16), num_envs=4096)   # on CUDA
    state, reward, done = env.step(cfg, state, actions)            # (E, 1, 3)

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
every kernel is replaced by its plain PyTorch version. Kernels build with
nvcc at first use; importing the package builds nothing.
"""

from . import config, convert, env
from .config import EnvConfig

__version__ = "0.1.0"
__all__ = ["config", "convert", "env", "EnvConfig"]
