"""The port's CUDA kernels (joints_island, K1; contact_island, K2;
solve_island, K3; track_pass, K4/K5; paint_view, K6) against their plain
PyTorch versions on an NVIDIA card. Imports no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the repository's conftest.py configures JAX.) Without a
card every test here skips."""

import dataclasses

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.physics import collide, fused_world, tire, track_cases, track_engine
from multi_car_racing_tpu_torch.physics import world
from multi_car_racing_tpu_torch.physics.state import apply_controls
from multi_car_racing_tpu_torch.render import pixels
from multi_car_racing_tpu_torch.util import tree_map
from test_torch_contact_compact import piled_cars
from test_torch_paint_cull import jitter


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
    k, ks, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    p, ps, _ = fused_world.island_step_plain(pre, state.wheel_on_road, state.contacts)
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
                                state.wheel_on_road, state.contacts)
    with pytest.raises(ValueError):
        fused_world.island_step(state.cars, state.wheel_on_road.float(), state.contacts)


def _k2_state(num_envs, num_cars, steps):
    """A driven batch at ``num_cars`` cars per env and the next step's input."""
    cfg = EnvConfig(num_agents=num_cars, use_random_direction=False)
    state = penv.reset_batch(cfg, range(8), num_envs, device="cuda")
    act = torch.as_tensor(np.random.RandomState(1).uniform(
        [-1, 0, 0], [1, 1, 0.2], size=(num_envs, num_cars, 3)), dtype=torch.float32,
        device="cuda")
    for _ in range(steps):
        state, _, _ = penv.step(cfg, state, act)
    return apply_controls(state.cars, act), state.wheel_on_road, state.contacts


def _assert_bars(name, ref, got, pre):
    d = float((ref - got).abs().max())
    assert d <= TOL * max(1.0, float(ref.abs().max())), name
    assert d <= TOL * max(STEP_FLOOR, float((ref - pre).abs().max())), name


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs,num_cars", [(1, 2), (300, 2), (64, 4)])
def test_contact_kernel_matches_plain_on_card(num_envs, num_cars):
    """contact_island (K2) against island_step_plain on the same card tensors
    after 40 driven steps (some envs broadphase-near, some in contact; ragged
    block edges included): every CarState field and both impulses within
    both bars, ids and limit states equal but for threshold flips in at
    most one env."""
    _need_card()
    pre, on_road, cs = _k2_state(num_envs, num_cars, 40)
    before = fused_world.island_step.contact_launches
    k, ks, kc = fused_world.island_step(pre, on_road, cs)
    p, ps, pc = fused_world.island_step_plain(pre, on_road, cs)
    torch.cuda.synchronize()
    assert fused_world.island_step.contact_launches == before + 1
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", pc.tangent_imp, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((kc.ids != pc.ids).any(1).sum()) <= 1
    assert int((ks != ps).sum()) <= 1


@pytest.mark.gpu
def test_contact_kernel_is_deterministic_and_sees_contacts():
    _need_card()
    pre, on_road, cs = _k2_state(512, 2, 40)
    assert bool(fused_world.near_flags(pre).any())
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs, 2)
    b = fused_world.launch_contacts(fin, ls_in, cs, 2)
    for x, y in zip((a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
                    (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)):
        assert torch.equal(x, y)
    assert bool((a[2].ids >= 0).any()) and float(a[2].normal_imp.max()) > 0


@pytest.mark.gpu
def test_contact_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    pre, on_road, cs = _k2_state(4, 2, 1)
    with pytest.raises(ValueError):
        fused_world.island_step(pre, on_road, type(cs)(cs.normal_imp, cs.tangent_imp,
                                                       cs.ids.long()))
    with pytest.raises(ValueError):
        fused_world.island_step(pre, on_road, type(cs)(cs.normal_imp[:, :47], cs.tangent_imp,
                                                       cs.ids))


def _spawn_tick(num_envs, num_cars=2):
    """A spawn tick's island inputs at ``num_envs`` envs (a env's two cars
    6 m apart on the grid: none near at N = 2)."""
    cfg = EnvConfig(num_agents=num_cars, use_random_direction=False)
    pool = penv.make_track_pool(cfg, range(4), device="cuda")
    idx, orders, dirs = penv.draw_episodes(cfg, num_envs, 4,
                                           torch.Generator(device="cuda").manual_seed(2))
    sp = penv.spawn_state(cfg, tree_map(lambda x: x.index_select(0, idx), pool), orders, dirs)
    return sp.cars, sp.wheel_on_road, sp.contacts


def _move_car1(cars, offset):
    hc, wc = cars.hull_c.clone(), cars.wheel_c.clone()
    hc[:, 1] += offset
    wc[:, 1] += offset[:, None]
    return cars.replace(hull_c=hc, wheel_c=wc)


def _all_far(num_envs):
    """A driven batch with car 1 of every env moved 500 m in x."""
    pre, on_road, cs = _k2_state(num_envs, 2, 40)
    off = torch.tensor([500.0, 0.0], device="cuda").expand(num_envs, 2)
    return _move_car1(pre, off), on_road, cs


def _all_near(num_envs):
    """A spawn tick with car 1 pulled to 2.7 m of car 0: every env near,
    each with a live manifold (the cars touch at rest, so the solve's normal
    impulses may all be zero)."""
    cars, on_road, cs = _spawn_tick(num_envs)
    return _move_car1(cars, -0.55 * (cars.hull_c[:, 1] - cars.hull_c[:, 0])), on_road, cs


def _piled():
    cars = piled_cars(8, 5)
    cars = cars.replace(**{f.name: getattr(cars, f.name).cuda() for f in dataclasses.fields(cars)})
    return (cars, torch.ones((8, 4, 4), dtype=torch.bool, device="cuda"),
            collide.init_contact_state(8, 4, device="cuda"))


def _check_k2_vs_plain(pre, on_road, cs, num_cars):
    k, ks, kc = fused_world.island_step(pre, on_road, cs)
    p, ps, pc = fused_world.island_step_plain(pre, on_road, cs)
    torch.cuda.synchronize()
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", pc.tangent_imp, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((kc.ids != pc.ids).any(1).sum()) <= 1
    assert int((ks != ps).sum()) <= 1
    return pc


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["driven", "all-far"])
def test_contact_far_envs_equal_k1_on_card(inputs):
    """K2's far pass runs each far env's cars through K1's chain: byte-equal
    to K1 on the same packed cars, zero impulses and ids -1; the near count
    it leaves on the card equals near_flags' sum."""
    _need_card()
    pre, on_road, cs = _k2_state(300, 2, 40) if inputs == "driven" else _all_far(300)
    near = fused_world.near_flags(pre)
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    fout, ls_out, kc = fused_world.launch_contacts(fin, ls_in, cs, 2)
    k1, k1_ls = fused_world.launch(fin, ls_in, fin.shape[1])
    torch.cuda.synchronize()
    assert int(fused_world.launch_contacts.near_count) == int(near.sum())
    far = (~near)[:, None].expand(-1, 2).reshape(-1)
    assert int(far.sum()) > 0
    assert torch.equal(fout[:, far], k1[:, far]) and torch.equal(ls_out[:, far], k1_ls[:, far])
    assert bool((kc.ids[~near] == -1).all()) and not bool(kc.normal_imp[~near].any())
    assert not bool(kc.tangent_imp[~near].any())


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["all-far", "all-near"])
def test_contact_kernel_matches_plain_on_all_far_and_all_near_batches(inputs):
    _need_card()
    pre, on_road, cs = _all_far(256) if inputs == "all-far" else _all_near(256)
    near = fused_world.near_flags(pre)
    assert bool(near.all()) if inputs == "all-near" else not bool(near.any())
    pc = _check_k2_vs_plain(pre, on_road, cs, 2)
    if inputs == "all-near":                   # the pulled cars touch: live manifolds
        assert bool((pc.ids >= 0).any(1).all())


@pytest.mark.gpu
def test_contact_kernel_over_32_live_rows_matches_plain_on_card():
    """Four overlapping cars per env: more than 32 live rows, so the near
    pass's rows loop past one per lane."""
    _need_card()
    pre, on_road, cs = _piled()
    live = fused_world.live_routing(collide.collide(pre, 4).point_ok, 4)[1]
    assert int(live.max()) > 32
    _check_k2_vs_plain(pre, on_road, cs, 4)


@pytest.mark.gpu
def test_contact_kernel_is_bit_identical_with_its_near_list_in_any_order():
    """Every env near: the far pass appends 4096 envs to the near list in an
    order that differs from launch to launch, and the outputs do not."""
    _need_card()
    pre, on_road, cs = _all_near(4096)
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs, 2)
    b = fused_world.launch_contacts(fin, ls_in, cs, 2)
    torch.cuda.synchronize()
    assert int(fused_world.launch_contacts.near_count) == 4096
    for x, y in zip((a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
                    (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)):
        assert torch.equal(x, y)


def _track_inputs(num_envs, num_cars, steps):
    """The track pass's inputs of the next step of a driven batch: (track,
    pre-solve cars, post-solve origin, visited, tile_touched)."""
    cfg = EnvConfig(num_agents=num_cars)
    state = penv.reset_batch(cfg, range(8), num_envs, device="cuda")
    act = torch.as_tensor(np.random.RandomState(2).uniform(
        [-1, 0, 0], [1, 1, 0.2], size=(num_envs, num_cars, 3)), dtype=torch.float32,
        device="cuda")
    for _ in range(steps):
        state, _, _ = penv.step(cfg, state, act)
    pre = apply_controls(state.cars, act)
    post, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    return state.track, pre, post.hull_origin, state.visited, state.tile_touched


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [1, 2, 4])
@pytest.mark.parametrize("num_envs", [1, 37, 4096])
def test_track_kernel_matches_plain_on_card(num_envs, num_cars):
    """track_pass (K4/K5) against track_pass_plain on the same card tensors
    after 12 driven steps: wheel_on_road, visited, tile_touched, on_grass,
    count and nearest_beta equal, bonus within 2e-5; two launches
    bit-identical."""
    _need_card()
    args = _track_inputs(num_envs, num_cars, 12)
    before = track_engine.track_pass.launches
    k = track_engine.track_pass(*args, num_cars)
    k2 = track_engine.track_pass(*args, num_cars)
    p = track_engine.track_pass_plain(*args, num_cars)
    torch.cuda.synchronize()
    assert track_engine.track_pass.launches == before + 2
    for name, a, b, c in zip(("wheel_on_road", "visited", "bonus", "count", "tile_touched",
                              "nearest_beta", "on_grass"), k, p, k2):
        assert torch.equal(a, c), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "bonus":
            assert float((a - b).abs().max()) <= 2e-5, name
        else:
            assert torch.equal(a, b), name
    assert bool(p[0].any())          # some wheel on the road


def _cull_track(num_cars: int):
    """The 8 host tracks of seeds 0-7 tiled to 256 envs on the card."""
    cfg = EnvConfig(num_agents=num_cars, use_random_direction=False)
    pool = penv.make_track_pool(cfg, range(8), device="cuda")
    idx = torch.arange(256, device="cuda") % 8
    return tree_map(lambda x: x.index_select(0, idx), pool)


def _assert_track_bars(k, p, k2, name):
    for label, a, b, c in zip(track_engine.OUTPUT_NAMES, k, p, k2):
        assert torch.equal(a, c), (name, label)
        if label == "bonus":
            assert float((a - b).abs().max()) <= 2e-5, (name, label)
        else:
            assert torch.equal(a, b), (name, label)


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [1, 2, 4])
def test_track_kernel_matches_plain_on_the_cull_edges(num_cars):
    """K4/K5 against track_pass_plain on track_cases.cull_cases at 256 envs
    (hull origins on the road and past the kerb, across the start seam, on
    a kerb, 30 m off the road, where the loop comes nearest to itself;
    wheels on the road with both origins 1 km away): the track bars, two
    launches bit-identical, and every tile the plain pass marks kept by
    track_engine.track_candidates."""
    _need_card()
    track = _cull_track(num_cars)
    for name, (cars, post, visited, touched) in track_cases.cull_cases(track, num_cars).items():
        args = (track, cars, post, visited, touched, num_cars)
        k = track_engine.track_pass(*args)
        k2 = track_engine.track_pass(*args)
        p = track_engine.track_pass_plain(*args)
        cand = track_engine.track_candidates(track, cars, post)
        torch.cuda.synchronize()
        assert not bool((track_engine.plain_marks(track, cars, post) & ~cand).any()), name
        _assert_track_bars(k, p, k2, name)
        assert name == "off-road" or bool(p[0].any()), name


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [1, 2, 4])
def test_track_kernel_cull_radii_are_the_plain_predicates(num_cars):
    """On track_cases.cull_probes (centreline points moved off the quads,
    so the cull drops marks), K4/K5 equals
    track_engine.track_pass_culled_plain under the track bars, and that
    differs from the full plain pass: the kernel's wheel and origin radii
    are track_candidates' and post_candidates'."""
    _need_card()
    track = _cull_track(num_cars)
    for name, args in track_cases.cull_probes(track, num_cars).items():
        args = args + (num_cars,)
        k = track_engine.track_pass(*args)
        k2 = track_engine.track_pass(*args)
        p = track_engine.track_pass_culled_plain(*args)
        full = track_engine.track_pass_plain(*args)
        torch.cuda.synchronize()
        _assert_track_bars(k, p, k2, name)
        assert not all(torch.equal(a, b) for a, b in zip(p, full)), name


@pytest.mark.gpu
def test_track_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    track, pre, post, visited, touched = _track_inputs(4, 2, 1)
    strided = track.quad_T.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == track.quad_T.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        track_engine.track_pass(dataclasses.replace(track, quad_T=strided), pre, post, visited, touched, 2)
    with pytest.raises(ValueError):
        track_engine.track_pass(dataclasses.replace(track, quad_lo=track.quad_lo.double()), pre, post,
                                visited, touched, 2)
    with pytest.raises(ValueError):
        track_engine.track_pass(track, pre, post, visited.to(torch.uint8), touched, 2)
    with pytest.raises(ValueError):
        track_engine.track_pass(track, pre, post, visited[:, :, :-1].contiguous(), touched, 2)
    with pytest.raises(ValueError):
        track_engine.track_pass(track, pre, post, visited, touched, 3)
    # The caps are the C entry point's: 33 cars is refused with CUDA's message.
    wheels = torch.zeros((4, 33, 4, 6), device="cuda")
    origins = torch.zeros((4, 33, 4), device="cuda")
    many = torch.zeros((4, 33, visited.shape[-1]), dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        track_engine.launch(track, wheels, origins, many, touched)


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [1, 2, 4])
@pytest.mark.parametrize("num_envs", [1, 37, 4096])
def test_paint_kernel_matches_plain_on_card(num_envs, num_cars):
    """paint_view (K6) against paint_views_plain on the same card tensors,
    every byte equal, on a batch driven 12 steps (every view warm: the whole
    track in world space), the same batch at t = 0.25, 0.5 and 0.75 s (warm,
    mid zoom), 2 s later (steady: the windowed slots), 2 s later with every
    camera jittered by sub-pixel amounts (edges near pixel centres and the
    corners of K6's cells) and mixed (every other env steady); two launches
    bit-identical."""
    _need_card()
    cfg = EnvConfig(num_agents=num_cars)
    state = penv.reset_batch(cfg, range(8), num_envs, device="cuda")
    act = torch.as_tensor(np.random.RandomState(3).uniform(
        [-1, 0, 0], [1, 1, 0.2], size=(num_envs, num_cars, 3)), dtype=torch.float32,
        device="cuda")
    for _ in range(12):
        state, _, _ = penv.step(cfg, state, act)
    odd = torch.arange(num_envs, device="cuda") % 2 == 1
    views = num_envs * num_cars
    cases = [("warm", state, views)]
    cases += [(f"t={t}", state.replace(t=torch.full_like(state.t, t)), views)
              for t in (0.25, 0.5, 0.75)]
    steady = state.replace(t=state.t + 2.0)
    cases += [("steady", steady, 0), ("jitter", jitter(steady, 11), 0),
              ("mixed", state.replace(t=torch.where(odd, state.t + 2.0, state.t)),
               (num_envs - num_envs // 2) * num_cars)]
    for label, st, warm_views in cases:
        args = pixels.paint_inputs(cfg, st)
        assert int((args[0][..., 5] > 0).sum()) == warm_views, label
        before = pixels.paint_views.launches
        k = pixels.paint_views(*args)
        k2 = pixels.paint_views(*args)
        p = pixels.paint_views_plain(*args)
        torch.cuda.synchronize()
        assert pixels.paint_views.launches == before + 2, label
        assert k.dtype == torch.uint8 and tuple(k.shape) == (num_envs, num_cars, 96, 96, 3)
        assert torch.equal(k, k2), label
        assert torch.equal(k, p), (label, int((k != p).sum()))


@pytest.mark.gpu
def test_paint_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    cfg = EnvConfig(num_agents=2)
    state = penv.reset_batch(cfg, (0,), 4, device="cuda")
    args = list(pixels.paint_inputs(cfg, state))

    def refused(i, bad, match=None):
        with pytest.raises(ValueError, match=match):
            pixels.paint_views(*(args[:i] + [bad] + args[i + 1:]))

    strided = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.shape == args[1].shape and not strided.is_contiguous()
    refused(1, strided, "contiguous")                       # quads
    refused(0, args[0].double())                            # cam
    refused(5, args[5].long())                              # score
    refused(10, args[10].to(torch.uint8))                   # valid
    refused(3, args[3][:, :, :-2].contiguous())             # p8 short of a hull slot
    refused(6, args[6][:, :-1].contiguous())                # quad with a tile missing
    # The kernel's own cap is its C entry point's: 33 cars is refused with
    # CUDA's message.
    E, n, mt = 1, 33, args[6].shape[1]
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device="cuda")
    many = (z(E, n, 8), z(E, n, pixels.SQ, 16), z(E, n, 8 * n, 16), z(E, n, 4 * n, 28),
            z(E, n, 8, 8), z(E, n, 4, 8, dtype=torch.int32), z(E, mt, 4, 2), z(E, mt, 4, 2),
            *(z(E, mt, dtype=torch.bool) for _ in range(4)))
    with pytest.raises(RuntimeError, match="invalid argument"):
        pixels.paint_views(*many)


def _solve_inputs(num_envs, num_cars, steps):
    """K3's inputs on the next step of a driven batch: the plain tire model
    and, at two or more cars, the plain Collide pass and make_bundle. Returns
    (pre-solve cars, wheel_on_road, contact carry, post-tire cars, force,
    motor speed, bundle or None, skid, manifolds or None)."""
    return _solve_from(*_k2_state(num_envs, num_cars, steps), num_cars)


def _solve_from(pre, on_road, cs, num_cars):
    """_solve_inputs' tuple from an island step's inputs."""
    post, force, motor, skid = tire.tire_step(pre, on_road)
    if num_cars == 1:
        return pre, on_road, cs, post, force, motor, None, skid, None
    man = collide.collide(post, num_cars)
    return (pre, on_road, cs, post, force, motor, collide.make_bundle(man, cs, post, num_cars),
            skid, man)


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [1, 2, 4])
@pytest.mark.parametrize("num_envs", [64, 4096])
def test_solve_kernel_matches_world_step_on_card(num_envs, num_cars):
    """solve_island (K3, through world_step_batched) against world.world_step
    on the same card tensors and bundle, after 40 driven steps at the full
    180/60 iterations: every CarState field and both impulses within both
    bars (the step's change taken from K3's input), limit states equal."""
    _need_card()
    *_, post, force, motor, bundle, _, _ = _solve_inputs(num_envs, num_cars, 40)
    before = fused_world.world_step_batched.launches
    _assert_solve_bars(post, force, motor, bundle, num_cars)
    assert fused_world.world_step_batched.launches == before + 1


def _assert_solve_bars(post, force, motor, bundle, num_cars=2):
    """K3 (world_step_batched) against world.world_step on the same card
    tensors and bundle: both bars, limit states equal."""
    k, k_imp = fused_world.world_step_batched(post, force, motor, bundle, num_cars)
    p, p_bundle = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(post, f))
    assert torch.equal(k.limit_state, p.limit_state)
    if bundle is None:
        assert k_imp is None
        return
    _assert_bars("normal_imp", p_bundle.normal_imp, k_imp[0], bundle.normal_imp)
    _assert_bars("tangent_imp", p_bundle.tangent_imp, k_imp[1], bundle.tangent_imp)


@pytest.mark.gpu
def test_solve_kernel_is_deterministic_and_sees_contacts():
    _need_card()
    *_, post, force, motor, bundle, _, _ = _solve_inputs(512, 2, 40)
    assert bool(bundle.man.point_ok.any())
    fin, ls_in = fused_world.pack_solve_inputs(post, force, motor)
    a = fused_world.launch_solve(fin, ls_in, bundle, 2)
    b = fused_world.launch_solve(fin, ls_in, bundle, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[2].max()) > 0


@pytest.mark.gpu
def test_contact_kernel_matches_plain_collide_and_solve_kernel_on_card():
    """K2's island step against the plain tire model, Collide pass and
    make_bundle followed by K3, after 40 driven steps: both bars on every
    CarState field and both impulses, ids equal but for threshold flips in
    at most one env."""
    _need_card()
    pre, on_road, cs, post, force, motor, bundle, skid, man = _solve_inputs(512, 2, 40)
    k, ks, kc = fused_world.island_step(pre, on_road, cs)
    s, (ni, ti) = fused_world.world_step_batched(post, force, motor, bundle, 2)
    torch.cuda.synchronize()
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(s, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", ni, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", ti, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, s.limit_state)
    assert int((kc.ids != man.ids).any(1).sum()) <= 1
    assert int((ks != skid).sum()) <= 1


@pytest.mark.gpu
def test_solve_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    *_, post, force, motor, bundle, _, _ = _solve_inputs(4, 2, 1)
    man = bundle.man

    def refused(b, match=None, n=2, cars=post):
        with pytest.raises(ValueError, match=match):
            fused_world.world_step_batched(cars, force, motor, b, n)

    strided = man.normal.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == man.normal.shape and not strided.is_contiguous()
    refused(dataclasses.replace(bundle, man=dataclasses.replace(man, normal=strided)),
            "contiguous")
    refused(dataclasses.replace(bundle, man=dataclasses.replace(
        man, point_ok=man.point_ok.float())))
    refused(dataclasses.replace(bundle, normal_imp=bundle.normal_imp[:, :47].contiguous()))
    refused(bundle, "cars per env", n=3)
    refused(bundle, cars=post.replace(hull_a=post.hull_a.double()))
    shifted = torch.zeros(man.point_ok.numel() + 1, dtype=torch.bool, device="cuda")[1:]
    shifted = shifted.view(man.point_ok.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    refused(dataclasses.replace(bundle, man=dataclasses.replace(man, point_ok=shifted)),
            "16-byte")
    with pytest.raises(ValueError, match="two or more cars"):
        fin, ls_in = fused_world.pack_solve_inputs(post, force, motor)
        fused_world.launch_solve(fin[:, ::2].contiguous(), ls_in[:, ::2].contiguous(), bundle, 1)


def _solve_case(name):
    """K3's (post-tire cars, force, motor speed, bundle) on a driven batch,
    an all-dead one (the all-far cars: no live point) and an all-live one
    (the all-near cars: every env touches)."""
    make = {"driven": lambda: _k2_state(512, 2, 40), "all-dead": lambda: _all_far(256),
            "all-live": lambda: _all_near(256)}[name]
    return _solve_from(*make(), 2)[3:7]


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["driven", "all-dead", "all-live"])
def test_solve_kernel_lists_exactly_the_live_envs(inputs):
    """K3's list pass: the count it leaves on the card equals
    solve_live_envs' sum, and the envs it listed are the live ones."""
    _need_card()
    post, force, motor, bundle = _solve_case(inputs)
    live = fused_world.solve_live_envs(bundle, post.hull_a.shape[0])
    assert bool(live.all()) if inputs == "all-live" else (
        not bool(live.any()) if inputs == "all-dead" else 0 < int(live.sum()) < live.numel())
    fin, ls_in = fused_world.pack_solve_inputs(post, force, motor)
    fused_world.launch_solve(fin, ls_in, bundle, 2)
    torch.cuda.synchronize()
    count = int(fused_world.launch_solve.live_count)
    assert count == int(live.sum())
    live_list = fused_world.launch_solve.live_list
    listed = torch.sort(live_list[:count].long()).values
    assert torch.equal(listed, live.nonzero().flatten())


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["all-dead", "all-live"])
def test_solve_kernel_matches_world_step_on_all_dead_and_all_live_batches(inputs):
    """K3 against world.world_step where every car runs alone (the all-far
    cars) and where every env is a live warp (the all-near cars)."""
    _need_card()
    _assert_solve_bars(*_solve_case(inputs))


@pytest.mark.gpu
def test_solve_kernel_is_bit_identical_with_its_live_list_in_any_order():
    """Every env live: the list pass appends 4096 envs to the live list in an
    order that differs from launch to launch, and the outputs do not."""
    _need_card()
    post, force, motor, bundle = _solve_from(*_all_near(4096), 2)[3:7]
    fin, ls_in = fused_world.pack_solve_inputs(post, force, motor)
    a = fused_world.launch_solve(fin, ls_in, bundle, 2)
    b = fused_world.launch_solve(fin, ls_in, bundle, 2)
    torch.cuda.synchronize()
    assert int(fused_world.launch_solve.live_count) == 4096
    for x, y in zip(a, b):
        assert torch.equal(x, y)
