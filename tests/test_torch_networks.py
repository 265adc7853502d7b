"""The port's actor-critic (learner/networks.py) against the JAX package's
flax ``ActorCritic``, on the CPU.

Flax parameters come from ``net.init`` with a fixed key and reach the port
through ``convert.policy_from_numpy``; the same numpy inputs go through both.

Bars: the state net (float32) within 1e-5 * max(1, |x|) on mean, log_std and
value; the pixel net (bfloat16 convolutions and Dense on both sides) within
1e-2 * max(1, max|JAX|) on mean and value, at K = 1 and 2 stacked frames.
The converter's round trip is exact. The port's own initialisation has
flax's statistics: the orthogonal kernels orthogonal at their gains, the
lecun_normal kernels' standard deviation within 5% of flax's, truncated at
two standard deviations, biases zero and log_std -0.5.
"""

import jax
import numpy as np
import pytest
import torch

from multi_car_racing_tpu.learner.networks import ActorCritic as JaxActorCritic

from multi_car_racing_tpu_torch import convert
from multi_car_racing_tpu_torch.learner import networks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

STATE_TOL = 1e-5
PIXEL_TOL = 1e-2


def _flax(obs_type, width, x):
    net = JaxActorCritic(obs_type=obs_type, width=width)
    params = net.init(jax.random.PRNGKey(3), x)
    return net, jax.tree_util.tree_map(np.asarray, params)


def _outputs(net, x):
    with torch.no_grad():
        return [t.numpy() for t in net(torch.from_numpy(x))]


def test_state_net_matches_jax():
    x = (3 * np.random.RandomState(0).randn(5, 2, 38)).astype(np.float32)
    jnet, params = _flax("state", 64, x)
    want = [np.asarray(t) for t in jax.jit(jnet.apply)(params, x)]
    net, _ = convert.policy_from_numpy(params, obs_type="state", width=64, frame_stack=1,
                                       device="cpu")
    got = _outputs(net, x)
    for name, w, g in zip(("mean", "log_std", "value"), want, got):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= STATE_TOL * max(1.0, float(np.abs(w).max())), name


@pytest.mark.parametrize("k", [1, 2])
def test_pixel_net_matches_jax(k):
    x = np.random.RandomState(k).randint(0, 256, (4, 96, 96, 3 * k)).astype(np.uint8)
    jnet, params = _flax("pixels", 256, x)
    want = [np.asarray(t) for t in jax.jit(jnet.apply)(params, x)]
    net, _ = convert.policy_from_numpy(params, obs_type="pixels", width=256, frame_stack=k,
                                       device="cpu")
    got = _outputs(net, x)
    for name, w, g in zip(("mean", "log_std", "value"), want, got):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= PIXEL_TOL * max(1.0, float(np.abs(w).max())), name
    assert np.array_equal(got[1], want[1])


def test_same_padding_is_flax_same():
    assert networks.same_padding(96, 8, 4) == (2, 2)
    assert networks.same_padding(24, 4, 2) == (1, 1)
    assert networks.same_padding(12, 3, 1) == (1, 1)
    assert networks.same_padding(7, 4, 2) == (1, 2)
    assert networks.same_padding(8, 4, 2) == (1, 1)
    assert networks.same_padding(9, 2, 2) == (0, 1)       # flax puts the odd pixel high
    assert networks.PADDINGS == [2, 1, 1] and networks.FLAT_DIM == 9216


@pytest.mark.parametrize("obs_type,k", [("state", 1), ("pixels", 2)])
def test_converter_round_trip_is_exact(obs_type, k):
    x = (np.zeros((1, 38), np.float32) if obs_type == "state"
         else np.zeros((1, 96, 96, 3 * k), np.uint8))
    _, params = _flax(obs_type, 64, x)
    rms = {"mean": np.arange(38, dtype=np.float32), "var": np.full(38, 2.5, np.float32),
           "count": np.float32(7.0)}
    net, trms = convert.policy_from_numpy(params, rms, obs_type=obs_type, width=64,
                                          frame_stack=k, device="cpu")
    back, brms = convert.policy_to_numpy(net, trms)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    for key in rms:
        assert np.array_equal(np.asarray(rms[key]), brms[key]), key


def test_converter_rejects_a_mismatched_config():
    x = np.zeros((1, 38), np.float32)
    _, params = _flax("state", 64, x)
    with pytest.raises(ValueError, match="StateTorso_0/Dense_0/kernel"):
        convert.policy_from_numpy(params, obs_type="state", width=32, frame_stack=1,
                                  device="cpu")
    px = np.zeros((1, 96, 96, 6), np.uint8)
    _, pparams = _flax("pixels", 64, px)
    with pytest.raises(ValueError, match="Conv_0/kernel"):
        convert.policy_from_numpy(pparams, obs_type="pixels", width=64, frame_stack=1,
                                  device="cpu")


def _check_orthogonal(k_in_out, gain):
    """A flax-layout kernel (in, out) is gain * a matrix with orthonormal
    columns (in >= out) or rows (in < out)."""
    m = k_in_out / gain
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=2e-5)


def test_init_statistics_match_flax():
    net = networks.ActorCritic("state", width=64, generator=torch.Generator().manual_seed(1))
    flax_params = _flax("state", 64, np.zeros((1, 38), np.float32))[1]["params"]
    tparams, _ = convert.policy_to_numpy(net)
    tparams = tparams["params"]
    for params in (tparams, flax_params):
        _check_orthogonal(params["StateTorso_0"]["Dense_0"]["kernel"], np.sqrt(2.0))
        _check_orthogonal(params["StateTorso_0"]["Dense_1"]["kernel"], np.sqrt(2.0))
        _check_orthogonal(params["Dense_0"]["kernel"], 0.01)
        _check_orthogonal(params["Dense_1"]["kernel"], 1.0)
        assert np.all(params["log_std"] == -0.5)
        for layer in ("Dense_0", "Dense_1"):
            assert not params[layer]["bias"].any()

    pnet = networks.ActorCritic("pixels", frame_stack=2,
                                generator=torch.Generator().manual_seed(2))
    tpx = convert.policy_to_numpy(pnet)[0]["params"]["PixelTorso_0"]
    fpx = _flax("pixels", 64, np.zeros((1, 96, 96, 6), np.uint8))[1]["params"]["PixelTorso_0"]
    for layer in ("Conv_0", "Conv_1", "Conv_2", "Dense_0"):
        kt, kf = tpx[layer]["kernel"], fpx[layer]["kernel"]
        assert kt.shape == kf.shape, layer
        fan_in = int(np.prod(kt.shape[:-1]))
        std = np.sqrt(1.0 / fan_in)
        assert abs(kt.std() / kf.std() - 1) < 0.05, layer
        assert abs(kt.std() / std - 1) < 0.05, layer
        bound = 2 * std / 0.87962566103423978
        assert np.abs(kt).max() <= bound * (1 + 1e-6), layer
        assert not tpx[layer]["bias"].any(), layer


def test_init_draws_from_the_generator():
    a = networks.ActorCritic("state", width=32, generator=torch.Generator().manual_seed(5))
    b = networks.ActorCritic("state", width=32, generator=torch.Generator().manual_seed(5))
    c = networks.ActorCritic("state", width=32, generator=torch.Generator().manual_seed(6))
    pa, pb, pc = (list(n.parameters()) for n in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not all(torch.equal(x, y) for x, y in zip(pa, pc))
