"""The PyTorch port's seeding, host track generator, packing and spawn poses
against the JAX package's: equal bit for bit.

Both packages get the same numpy inputs; the port runs on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from multi_car_racing_tpu import seeding as j_seeding
from multi_car_racing_tpu.track import common as j_common, host as j_host

from multi_car_racing_tpu_torch import config as p_config, seeding as p_seeding
from multi_car_racing_tpu_torch.track import common as p_common, host as p_host

SEEDS = (0, 1, 2, 7, 42, 123, 999, 31337)
MT = p_config.EnvConfig().max_tiles


def _track(seed):
    rng_j, _ = j_seeding.np_random(seed)
    rng_p, _ = p_seeding.np_random(seed)
    return j_host.generate_track(rng_j), p_host.generate_track(rng_p), rng_j, rng_p


@pytest.mark.parametrize("seed", [0, 1, 5, 2**31 - 1, 2**40 + 3, "carracing"])
def test_seeding_chain_matches(seed):
    assert p_seeding.create_seed(seed) == j_seeding.create_seed(seed)
    if isinstance(seed, int):
        assert p_seeding.hash_seed(seed) == j_seeding.hash_seed(seed)
        rj, sj = j_seeding.np_random(seed)
        rp, sp = p_seeding.np_random(seed)
        assert sj == sp
        assert np.array_equal(rj.uniform(size=64), rp.uniform(size=64))


def test_global_stream_matches():
    for seed in SEEDS:
        gj, gp = j_seeding.GlobalStream(seed), p_seeding.GlobalStream(seed)
        for n in (1, 2, 4):
            assert gj.direction() == gp.direction()
            assert np.array_equal(gj.car_order(n), gp.car_order(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_track_matches(seed):
    (pj, bj, nj), (pp, bp, np_), rng_j, rng_p = _track(seed)
    assert nj == np_
    assert pj.dtype == pp.dtype and np.array_equal(pj, pp)
    assert np.array_equal(bj, bp)
    # Retries consume the same stream: the generators leave it in one place.
    assert np.array_equal(rng_j.uniform(size=4), rng_p.uniform(size=4))


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_track_matches(seed):
    (pts, border, _), _, _, _ = _track(seed)
    tj = j_common.pack_track(pts, border, max_tiles=MT)
    tp = p_common.pack_track(pts, border, max_tiles=MT, device="cpu")
    for f in dataclasses.fields(p_common.Track):
        a = np.asarray(getattr(tj, f.name))
        b = getattr(tp, f.name)
        assert b.shape[0] == 1, f.name
        b = b[0].numpy()
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("seed", SEEDS)
def test_spawn_poses_match(seed):
    (pts, border, _), _, _, _ = _track(seed)
    packed = p_common.pack_track_arrays(pts, border, MT)
    gs = np.random.RandomState(seed)
    for n in (1, 2, 4):
        order = gs.permutation(n)
        for cw in (False, True):
            pj, aj = j_common.spawn_poses(packed["xy"], packed["beta"], len(pts), order, cw)
            pp, ap = p_common.spawn_poses(packed["xy"], packed["beta"], len(pts), order, cw)
            assert np.array_equal(pj, pp) and np.array_equal(aj, ap)


def test_track_batch_stacks_envs():
    arrays = []
    for seed in SEEDS[:3]:
        (pts, border, _), _, _, _ = _track(seed)
        arrays.append(p_common.pack_track_arrays(pts, border, MT))
    tr = p_common.track_from_arrays(arrays, device="cpu")
    assert tr.n_tiles.dtype == torch.int32 and tr.n_tiles.shape == (3,)
    assert tr.quad_T.shape == (3, 4, 2, MT) and tr.max_tiles == MT
    for e, a in enumerate(arrays):
        assert np.array_equal(tr.xy[e].numpy(), a["xy"])
