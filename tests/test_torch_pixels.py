"""The port's pixel observation (obs.pixel_observation_batched, i.e.
render.pixels.render_pixels) on the CPU, where the painter runs its plain
PyTorch version (paint_views_plain):

- byte-equal to each of the five 96x96 golden frames
  (tests/fixtures/golden: N = 1, 2 and 4 cars, CCW and CW, warm and steady,
  ego colour, the backwards flag over the HUD), the states loaded through
  ``convert.env_state_from_leaves``;
- the wrapper's dispatch: CPU tensors go to the plain version, which counts
  only its calls on CUDA tensors; other devices are refused.

``mixed_batch`` builds the mixed warm/steady batch that
tests/test_torch_pixels_pallas.py holds against the JAX painters.
"""

import numpy as np
import pytest
import torch

from multi_car_racing_tpu.render import raster as JR

from multi_car_racing_tpu_torch import EnvConfig, convert, obs
from multi_car_racing_tpu_torch.render import pixels as PP, raster as PR
from multi_car_racing_tpu_torch.util import tree_leaves
from test_torch_render import GOLDENS, golden
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# The mixed batch: (golden, t). Warm while t < 0.999 s (pallas_raster.py:116).
MIXED = (("steady_2agent", None), ("warmup_2agent", None), ("backwards_flag", None),
         ("steady_2agent", 0.5))


def mixed_batch():
    """(config kwargs, the leaves of E = 4 envs with the t of MIXED, the
    envs' warm flags)."""
    parts = [golden(name) for name, _ in MIXED]
    kw = parts[0][0]
    assert all(EnvConfig(**p[0]) == EnvConfig(**kw) for p in parts)
    st = convert.env_state_from_leaves(
        [np.concatenate(xs) for xs in zip(*(p[1] for p in parts))], device="cpu")
    t = st.t.clone()
    for e, (_, te) in enumerate(MIXED):
        if te is not None:
            t[e] = te
    leaves = [x.numpy() for x in tree_leaves(st.replace(t=t))]
    return kw, leaves, (t < 0.999).tolist()


@pytest.mark.parametrize("name", GOLDENS)
def test_pixels_match_golden(name):
    kw, leaves, frame = golden(name)
    st = convert.env_state_from_leaves(leaves, device="cpu")
    img = obs.pixel_observation_batched(EnvConfig(**kw), st)
    assert img.dtype == torch.uint8 and img.device.type == "cpu"
    assert tuple(img.shape) == (1,) + frame.shape
    bad = (img[0].numpy() != frame).any(-1)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:8].tolist())


def test_paint_views_dispatch():
    kw, leaves, _ = golden("cw_1agent")
    cfg = EnvConfig(**kw)
    args = PP.paint_inputs(cfg, convert.env_state_from_leaves(leaves, device="cpu"))
    before = (PP.paint_views.launches, PP.paint_views_plain.cuda_calls)
    assert torch.equal(PP.paint_views(*args), PP.paint_views_plain(*args))
    assert (PP.paint_views.launches, PP.paint_views_plain.cuda_calls) == before
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError, match="unsupported device"):
        PP.paint_views(*meta)
    np.testing.assert_array_equal(PR.PALETTE_U8, JR.PALETTE_U8)
    assert (PR.W1, PR.W2, PR.WS) == (JR.W1, JR.W2, JR.WS)
