"""The port's pixel observation on the CPU against the JAX package's two
96x96 painters, byte for byte, on a mixed batch of E = 4 envs built from the
three N = 2 goldens (``test_torch_pixels.mixed_batch``), with ``t`` set so
that two envs are in the first-second zoom-out (warm: the whole track in
world space) and two are steady (windowed slots):

- the XLA painter ``render/raster.py::render_observation``, jitted and
  vmapped;
- the Pallas painter ``render/pallas_raster.py::render_pixels`` (the TPU
  kernel K6) in interpret mode, called once: it compiles both kernel
  variants, which takes most of this file's time.
"""

from functools import partial

import jax
import numpy as np
import pytest

from multi_car_racing_tpu import config as JC
from multi_car_racing_tpu.render import pallas_raster as JPR, raster as JR

from multi_car_racing_tpu_torch import EnvConfig, convert, obs
from test_torch_pixels import mixed_batch
from test_torch_render import jax_from_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def batch():
    """The mixed batch and the port's frames of it, painted once for both
    tests."""
    kw, leaves, warm = mixed_batch()
    assert warm == [False, True, False, True]
    img = obs.pixel_observation_batched(EnvConfig(**kw), convert.env_state_from_leaves(
        leaves, device="cpu")).numpy()
    return kw, leaves, img


def test_mixed_batch_matches_jax_pallas_kernel(batch):
    kw, leaves, img = batch
    ref = np.asarray(JPR.render_pixels(JC.EnvConfig(**kw), jax_from_leaves(leaves),
                                       interpret=True))
    assert img.shape == ref.shape == (4, 2, 96, 96, 3)
    bad = (img != ref).any(-1)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:8].tolist())


def test_mixed_batch_matches_jax_painter(batch):
    kw, leaves, img = batch
    ref = np.asarray(jax.jit(jax.vmap(partial(JR.render_observation, JC.EnvConfig(**kw))))(
        jax_from_leaves(leaves)))
    assert img.shape == ref.shape == (4, 2, 96, 96, 3)
    bad = (img != ref).any(-1)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:8].tolist())
    # The warm frames show far track the windows would miss; the frames differ.
    assert not np.array_equal(img[0], img[3])
