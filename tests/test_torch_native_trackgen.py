"""The port's native track generator (``native.py``, ``csrc/trackgen.cpp``)
against the port's Python walk and the JAX package's Python walk
(``track/host.generate_track``), on the CPU.

- Seeds 0-63, nine of which retry: tracks, curbs and retry counts equal bit
  for bit, and so are the next 16 draws of each stream; a second track drawn
  from the same stream (the reference never reseeds) is equal too.
- A failed build raises with the compiler's message, and nothing falls back
  to the Python walk.
- ``env.host_reset``, ``env.reset_batch``, ``env.make_host_track_pool`` and
  the Gym facade's reset take their tracks from the native generator.

The JAX package's own native generator is not built here: that would write
its library into the JAX package.
"""

import numpy as np
import pytest

from multi_car_racing_tpu import seeding as jseed
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import EnvConfig, env as penv, gym_api, native, seeding
from multi_car_racing_tpu_torch.track import host as phost

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].dtype == b[1].dtype == bool and a[0].dtype == b[0].dtype == np.float64
    assert a[2] == b[2]


@pytest.mark.parametrize("block", range(4))
def test_native_equals_both_python_walks(block):
    retried = 0
    for seed in range(block, 64, 4):
        rngs = [seeding.np_random(seed)[0], seeding.np_random(seed)[0],
                jseed.np_random(seed)[0]]
        fast = phost.generate_track_fast(rngs[0])
        _equal(fast, phost.generate_track(rngs[1]))
        _equal(fast, jhost.generate_track(rngs[2]))
        retried += fast[2] > 0
        # Stream continuation: the next track and the next 16 draws.
        fast2 = phost.generate_track_fast(rngs[0])
        _equal(fast2, phost.generate_track(rngs[1]))
        _equal(fast2, jhost.generate_track(rngs[2]))
        draws = [r.random_sample(16) for r in rngs]
        np.testing.assert_array_equal(draws[0], draws[1])
        np.testing.assert_array_equal(draws[0], draws[2])
    assert retried > 0            # each block holds seeds that retry (9 of 0-63)


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.load() is None
    assert "missing.cpp" in native.build_error()
    assert "No such file" in native.build_error()         # g++'s own stderr
    rng = seeding.np_random(0)[0]
    state = rng.get_state()
    with pytest.raises(RuntimeError, match="No such file"):
        phost.generate_track_fast(rng)
    after = rng.get_state()                              # the stream is untouched
    assert np.array_equal(state[1], after[1]) and state[2] == after[2]


def test_host_resets_use_the_native_generator():
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    native.generate_track.calls = 0
    penv.host_reset(cfg, seed=3, device="cpu")
    assert native.generate_track.calls == 1
    penv.reset_batch(cfg, (3, 4), 4, device="cpu")
    assert native.generate_track.calls == 3
    pool = penv.make_host_track_pool(cfg, (3, 4, 5), device="cpu")
    assert native.generate_track.calls == 6
    # The pool's tracks are the Python walk's, packed.
    want = phost.generate_track(seeding.np_random(5)[0])[0]
    assert int(pool.n_tiles[2]) == len(want)
    facade = gym_api.MultiCarRacing(num_agents=1, device="cpu")
    facade.seed(3)
    facade.reset()
    assert native.generate_track.calls == 7
