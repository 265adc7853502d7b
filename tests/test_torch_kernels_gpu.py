"""The port's CUDA kernels against their plain PyTorch versions on an NVIDIA
card. Imports no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the repository's conftest.py configures JAX.) Without a
card every test here skips."""

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.physics import fused_world
from multi_car_racing_tpu_torch.physics.state import apply_controls

TOL = 5e-4
STEP_FLOOR = 1e-3     # floor of the per-step-change scale
CAR_FIELDS = ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a",
              "wheel_v", "wheel_w", "joint_impulse", "motor_impulse", "spin",
              "phase", "fuel_spent")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs", [1, 63, 256])
def test_island_kernel_matches_plain_on_card(num_envs):
    """The joints_island kernel against island_step_plain on the same card
    tensors, after 15 driven steps (ragged block edges included). Each field
    is held on its value and on the step's change, so a position-solve error
    of a millimetre shows on coordinates of hundreds of metres."""
    _need_card()
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    state = penv.reset_batch(cfg, range(8), num_envs, device="cuda")
    act = torch.as_tensor(np.random.RandomState(0).uniform(
        [-1, 0, 0], [1, 1, 0.2], size=(num_envs, 1, 3)), dtype=torch.float32, device="cuda")
    for _ in range(15):
        state, _, _ = penv.step(cfg, state, act)
    before = fused_world.island_step.launches
    pre = apply_controls(state.cars, act)
    k, ks = fused_world.island_step(pre, state.wheel_on_road)
    p, ps = fused_world.island_step_plain(pre, state.wheel_on_road)
    torch.cuda.synchronize()
    assert fused_world.island_step.launches == before + 1
    for f in CAR_FIELDS:
        a, b, before_step = getattr(p, f), getattr(k, f), getattr(pre, f)
        d = float((a - b).abs().max())
        assert d <= TOL * max(1.0, float(a.abs().max())), f
        assert d <= TOL * max(STEP_FLOOR, float((a - before_step).abs().max())), f
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((ks != ps).sum()) <= 1


@pytest.mark.gpu
def test_island_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    state = penv.reset_batch(cfg, (0,), 4, device="cuda")
    with pytest.raises(ValueError):
        fused_world.island_step(state.cars.replace(hull_a=state.cars.hull_a.double()),
                                state.wheel_on_road)
    with pytest.raises(ValueError):
        fused_world.island_step(state.cars, state.wheel_on_road.float())
