"""The port's on-device track generator (``track/device.py``) and the episode
functions built on it (``env.device_reset``, ``env.make_track_pool_checked``)
against the JAX package's, on the CPU.

- The same (12, 2) checkpoint uniforms through both generators (JAX through
  a stand-in for its ``_checkpoints``, as tests/test_track_device.py feeds
  it the host's draws): equal tile counts, centre points within 2e-2 and
  headings within 2e-3, curb flags differing on under 2% of tiles (JAX's own
  bars of its device tracks against the host's float64 ones: both walks are
  2,500 dependent float32 steps).
- JAX's extracted points through both ``_build_track``s: ``has_curb`` and
  every other flag and count equal, every float field within 1e-5 absolute
  but the SAT intervals ``quad_lo`` / ``quad_hi``, within 1e-5 times the
  tile's largest |vertex coordinate|: a projection of coordinates of up to
  ~300 m onto an edge normal of a 3.5 m edge, which inherits the vertices'
  one-ulp float32 differences (the two libraries' cos and sin) as ~5e-6
  relative error (3e-4 m seen on the CPU).
- The destination scan's 13 candidate stops against an unbounded loop on the
  walk's own inputs, step by step: the same result, within 12 advances.
- 64 tracks from fixed seeds in each package: the mean tile count within 20
  tiles and the first-attempt success rate within 0.15 (each about 3.5
  standard errors of the difference of two such samples).
- Generation failure is loud: ``device_reset`` marks the env done at the time
  limit, the checked pool raises.
- ``device_reset`` then 5 steps: the spawn tiles visited, rewards finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC
from multi_car_racing_tpu.track import device as jdev

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.track import device as pdev
from multi_car_racing_tpu_torch.track.common import Track
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MT, POINTS = 384, 2500
DRAWS = 6                     # checkpoint draws fed to both generators
STAT_TRACKS, STAT_SEED = 64, 3
MEAN_TILES_BAR, SUCCESS_BAR = 20.0, 0.15
SHORT_POINTS = 40             # a walk too short to close a loop: every attempt fails
UNIFORMS = np.random.RandomState(2024).uniform(size=(DRAWS, JC.CHECKPOINTS, 2)).astype(np.float32)


def _jax_checkpoints(key, dtype=jnp.float32):
    """JAX's ``_checkpoints`` fed UNIFORMS[key[0]]: its own arithmetic on
    the port's draws."""
    ncp = JC.CHECKPOINTS
    u = jnp.take(jnp.asarray(UNIFORMS), key[0], axis=0).astype(dtype)
    c = jnp.arange(ncp, dtype=dtype)
    alpha = 2 * np.pi * c / ncp + u[:, 0] * (2 * np.pi / ncp)
    rad = JC.TRACK_RAD / 3 + u[:, 1] * (JC.TRACK_RAD - JC.TRACK_RAD / 3)
    alpha = alpha.at[0].set(0.0).at[ncp - 1].set(2 * np.pi * (ncp - 1) / ncp)
    rad = rad.at[0].set(1.5 * JC.TRACK_RAD).at[ncp - 1].set(1.5 * JC.TRACK_RAD)
    return alpha, rad * jnp.cos(alpha), rad * jnp.sin(alpha)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's attempts on UNIFORMS and its tracks built from them, its first
    attempts and generated tracks on STAT_TRACKS keys: one jit each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdev, "_checkpoints", _jax_checkpoints)

        def fed(i):
            parts = jdev._attempt(jnp.stack([i, jnp.uint32(0)]), MT, POINTS)
            t_beta, t_x, t_y, valid, L, _ = parts
            return parts, jdev._build_track(t_beta, t_x, t_y, valid, jnp.maximum(L, 1), MT)

        draws = jnp.arange(DRAWS, dtype=jnp.uint32)
        parts, tracks = jax.device_get(jax.jit(jax.vmap(fed))(draws))
        short = jax.device_get(jax.jit(jax.vmap(
            lambda i: jdev._attempt(jnp.stack([i, jnp.uint32(0)]), MT, SHORT_POINTS)))(draws))
    keys = jax.random.split(jax.random.PRNGKey(STAT_SEED), STAT_TRACKS)
    first_ok = jax.device_get(jax.jit(jax.vmap(lambda k: jdev._attempt(k, MT, POINTS)[-1]))(keys))
    gen_tracks, gen_ok = jax.device_get(jax.jit(jax.vmap(
        lambda k: jdev.generate_track(k, MT, POINTS, 12)))(keys))
    return {"parts": parts, "tracks": tracks, "short": short, "first_ok": first_ok,
            "n_tiles": gen_tracks.n_tiles, "ok": gen_ok}


@pytest.fixture(scope="module")
def port_parts():
    return pdev._attempt(*pdev.checkpoints_from_uniforms(torch.from_numpy(UNIFORMS)), MT, POINTS)


def test_same_uniforms_same_tracks(jax_runs, port_parts):
    t_beta, t_x, t_y, valid, L, ok = port_parts
    j_ok, j_L = jax_runs["parts"][5], jax_runs["parts"][4]
    assert np.array_equal(ok.numpy(), j_ok) and int(ok.sum()) >= 3
    assert np.array_equal(L.numpy(), j_L)
    mine = pdev._build_track(t_beta, t_x, t_y, valid, L.clamp(min=1), MT)
    want = jax_runs["tracks"]
    for d in np.flatnonzero(j_ok):
        n = int(j_L[d])
        assert int(mine.n_tiles[d]) == int(want.n_tiles[d]) == n
        np.testing.assert_allclose(mine.xy[d, :n].numpy(), want.xy[d, :n], atol=2e-2)
        np.testing.assert_allclose(mine.beta[d, :n].numpy(), want.beta[d, :n], atol=2e-3)
        assert (mine.has_curb[d, :n].numpy() != want.has_curb[d, :n]).mean() < 0.02


def test_failed_attempts_keep_what_jax_keeps(jax_runs, port_parts):
    """A failed attempt's points are what JAX extracts too, as the track a
    lane keeps when every retry fails: on a glue failure the walk's slice
    (draw 0 here), and with fewer than two start crossings (a 40-step walk)
    the zero padding that JAX's dynamic_slice reads from its wrapped
    start."""
    want = [np.asarray(a) for a in jax_runs["parts"]]
    failed = np.flatnonzero(~want[5])
    assert failed.size and not port_parts[5].numpy()[failed].any()
    for got, ref, tol in zip(port_parts[:3], want[:3], (2e-3, 2e-2, 2e-2)):
        np.testing.assert_allclose(got.numpy()[failed], ref[failed], atol=tol)
    short = pdev._attempt(*pdev.checkpoints_from_uniforms(torch.from_numpy(UNIFORMS)), MT,
                          SHORT_POINTS)
    for got, ref in zip(short, jax_runs["short"]):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert not short[5].any() and not short[3].any()


def test_build_track_matches_jax_on_the_same_points(jax_runs):
    t_beta, t_x, t_y, valid, L, _ = (torch.from_numpy(np.array(a)) for a in jax_runs["parts"])
    mine = pdev._build_track(t_beta, t_x, t_y, valid, L.clamp(min=1), MT)
    want = jax_runs["tracks"]
    # (P, 1, MT): each tile's largest |vertex coordinate|, the scale of its
    # SAT intervals.
    tile_scale = np.maximum(1.0, np.abs(np.asarray(want.quad)).max(axis=(-1, -2)))[:, None]
    for f in dataclasses.fields(Track):
        got, ref = getattr(mine, f.name), np.asarray(getattr(want, f.name))
        assert got.is_contiguous() and tuple(got.shape) == ref.shape, f.name
        if not got.is_floating_point():
            assert np.array_equal(got.numpy(), ref), f.name
        else:
            assert got.dtype == torch.float32, f.name
            bar = 1e-5 * (tile_scale if f.name in ("quad_lo", "quad_hi") else 1.0)
            assert (np.abs(got.numpy() - ref) <= bar).all(), f.name


def _unbounded_scan(dest_i: int, alpha: np.float32, cp_alpha: np.ndarray):
    """JAX's while_loop of the destination scan, one track, unbounded."""
    steps = 0
    while alpha > cp_alpha[dest_i % JC.CHECKPOINTS]:
        dest_i += 1
        steps += 1
        if dest_i % JC.CHECKPOINTS == 0:
            alpha = np.float32(alpha - np.float32(2 * np.pi))
    return dest_i, alpha, steps


def test_destination_scan_ends_within_twelve_advances(monkeypatch):
    real = pdev._dest_scan
    seen = {"calls": 0, "most": 0}

    def checked(dest_i, alpha, cp_alpha):
        got_i, got_a = real(dest_i, alpha, cp_alpha)
        cp = cp_alpha.numpy()
        for p in range(dest_i.shape[0]):
            want_i, want_a, steps = _unbounded_scan(int(dest_i[p]), np.float32(alpha[p]), cp[p])
            assert int(got_i[p]) == want_i and np.float32(got_a[p]) == want_a
            seen["most"] = max(seen["most"], steps)
        seen["calls"] += 1
        return got_i, got_a

    monkeypatch.setattr(pdev, "_dest_scan", checked)
    pdev._walk(*pdev.checkpoints_from_uniforms(torch.from_numpy(UNIFORMS[:2])), POINTS)
    assert seen["calls"] == POINTS and 1 <= seen["most"] <= 12


def test_track_statistics_match_jax(jax_runs):
    g = torch.Generator().manual_seed(STAT_SEED)
    first_ok = pdev._attempt(*pdev._checkpoints(g, STAT_TRACKS), MT, POINTS)[-1]
    tracks, ok = pdev.generate_tracks(g, STAT_TRACKS, MT, POINTS, 12)
    assert bool(ok.all()) and bool(jax_runs["ok"].all())
    n = tracks.n_tiles.numpy()
    assert ((n >= 200) & (n <= MT)).all()
    assert abs(n.mean() - jax_runs["n_tiles"].mean()) <= MEAN_TILES_BAR
    assert abs(first_ok.float().mean().item() - jax_runs["first_ok"].mean()) <= SUCCESS_BAR
    # Structure (tests/test_track_device.py's): closed loops inside the
    # playfield, with curbs.
    for e in range(0, STAT_TRACKS, 8):
        L = int(n[e])
        assert int(tracks.valid[e].sum()) == L
        xy = tracks.xy[e, :L].numpy()
        assert np.isfinite(xy).all() and (np.abs(xy) < JC.PLAYFIELD).all()
        assert np.linalg.norm(xy[0] - xy[-1]) < 3 * JC.TRACK_DETAIL_STEP
        assert 10 < int(tracks.has_curb[e].sum()) < L


def test_generation_failure_is_loud(monkeypatch):
    def always_fail(cp_alpha, cp_x, cp_y, max_tiles, max_points):
        z = torch.zeros((cp_alpha.shape[0], max_tiles))
        return (z, z, z, z.bool(), torch.zeros(cp_alpha.shape[0], dtype=torch.int32),
                torch.zeros(cp_alpha.shape[0], dtype=torch.bool))

    monkeypatch.setattr(pdev, "_attempt", always_fail)
    cfg = EnvConfig(num_agents=1, velocity_iters=2, position_iters=2, max_track_retries=2)
    state = penv.device_reset(cfg, torch.Generator().manual_seed(0), 2)
    assert bool(state.done.all()), "failed generation must mark the env done"
    assert bool((state.steps >= cfg.max_episode_steps).all())
    assert bool(penv.episode_over(cfg, state).all())
    with pytest.raises(RuntimeError, match="failed generation"):
        penv.make_track_pool_checked(cfg, torch.Generator().manual_seed(1), 2, max_rounds=2)


def test_config_bounds_reach_the_generator(monkeypatch):
    seen = []
    real = pdev._attempt

    def spy(cp_alpha, cp_x, cp_y, max_tiles, max_points):
        seen.append((max_tiles, max_points))
        return real(cp_alpha, cp_x, cp_y, max_tiles, max_points)

    monkeypatch.setattr(pdev, "_attempt", spy)
    cfg = EnvConfig(num_agents=1, max_track_points=40, max_track_retries=3)
    tracks, ok = penv.make_track_pool(cfg, torch.Generator().manual_seed(0), 2)
    assert seen == [(cfg.max_tiles, 40)] * 3 and not bool(ok.any())   # 40 steps close no loop
    assert tuple(tracks.xy.shape) == (2, cfg.max_tiles, 2)


def test_device_reset_and_step():
    cfg = EnvConfig(num_agents=2, velocity_iters=30, position_iters=12)
    state = penv.device_reset(cfg, torch.Generator().manual_seed(3), 1)
    assert int(state.tile_visited_count.sum()) > 0, "spawn tiles visited"
    assert not bool(state.done.any()) and int(state.steps[0]) == 1
    a = torch.tensor([[[0.0, 0.5, 0.0]] * 2])
    for _ in range(5):
        state, r, d = penv.step(cfg, state, a)
    assert bool(torch.isfinite(r).all()) and not bool(d.any())
