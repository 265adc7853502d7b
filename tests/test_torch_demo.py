"""The port's demo and terminal player (``demo``, ``tui``) against the JAX
package's, on the CPU.

- ``tui.frame_to_ansi`` and ``tui.actions_from_keys`` give JAX's strings and
  arrays on the same inputs (tests/test_aux.py's frame and keys, a random
  frame, every key binding held and released).
- ``demo.heuristic_actions`` equals JAX's on one facade state after three
  steps (JAX reads the same state through the same field names).
- ``demo.main`` drives the facade 20 steps on the CPU and writes a GIF of
  the recorded view (the env at 8/3 solver iterations).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from PIL import Image

from multi_car_racing_tpu import demo as jdemo, tui as jtui

from multi_car_racing_tpu_torch import convert, demo, gym_api, tui
from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_frame_to_ansi_matches_jax():
    img = np.zeros((96, 96, 3), np.uint8)
    img[0, 0] = (255, 0, 0)
    rand = np.random.RandomState(0).randint(0, 256, (95, 40, 3)).astype(np.uint8)
    for frame in (img, rand, rand[:10:, :7]):
        assert tui.frame_to_ansi(frame) == jtui.frame_to_ansi(frame)
    s = tui.frame_to_ansi(img)
    assert s.count("\n") == 47 and "38;2;255;0;0" in s


@pytest.mark.parametrize("num_agents", [1, 2, 3])
def test_actions_from_keys_match_jax(num_agents):
    keys = [k for car in tui.CAR_CONTROL_KEYS for k in car]
    assert tui.CAR_CONTROL_KEYS == jtui.CAR_CONTROL_KEYS
    rng = np.random.RandomState(num_agents)
    cases = [{"UP": 1.0, "a": 1.0, "s": 1.0}, {}, {k: 1.0 for k in keys}]
    cases += [{k: float(rng.uniform(-1, 1)) for k in keys} for _ in range(20)]
    for held in cases:
        got = tui.actions_from_keys(held, num_agents, 0.0)
        want = jtui.actions_from_keys(held, num_agents, 0.0)
        assert got.dtype == want.dtype and np.array_equal(got, want), held


def _short_make(**extra):
    """gym_api.make with the facade's env at 8/3 solver iterations."""
    original = gym_api.make

    def make(env_id, **kw):
        env = original(env_id, **{**kw, **extra})
        env.env.cfg = dataclasses.replace(env.env.cfg, velocity_iters=8, position_iters=3)
        return env
    return make


def test_heuristic_actions_match_jax():
    env = _short_make(device="cpu")("MultiCarRacing-v0", num_agents=2, verbose=0)
    env.seed(3)
    env.reset()
    for _ in range(3):
        env.step(demo.heuristic_actions(env))
    got = demo.heuristic_actions(env)
    jstate = jax.tree_util.tree_map(lambda x: x[0],
                                    jax_state(convert.env_state_to_numpy(env.state)))
    want = jdemo.heuristic_actions(SimpleNamespace(state=jstate, num_agents=2))
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got[:, 0]).max() > 0                   # the follower steers


def test_demo_main_writes_a_gif(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(demo.gym_api, "make", _short_make())
    out = str(tmp_path / "demo.gif")
    total = demo.main(["--steps", "20", "--out", out, "--device", "cpu", "--every", "4"])
    printed = capsys.readouterr().out
    assert "Step 0 Total_reward" in printed and f"wrote {out} (5 frames)" in printed
    assert total.shape == (2,) and np.isfinite(total).all()
    with Image.open(out) as gif:
        assert gif.n_frames == 5 and gif.size == (192, 192)
