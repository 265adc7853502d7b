"""The port's CUDA kernels (joints_island, K1; contact_island, K2;
solve_island, K3; track_pass, K4/K5; paint_view, K6) against their plain
PyTorch versions on an NVIDIA card. Imports no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the repository's conftest.py configures JAX.) Without a
card every test here skips."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.physics import collide, fused_world, tire, track_cases, track_engine
from multi_car_racing_tpu_torch.physics import world
from multi_car_racing_tpu_torch.physics.state import apply_controls
from multi_car_racing_tpu_torch.render import pixels
from multi_car_racing_tpu_torch.util import tree_map
from test_torch_contact_compact import piled_cars, piled_groups
from test_torch_paint_cull import jitter


CSRC = Path(fused_world.__file__).parent.parent / "csrc"
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


def _contact_state(num_envs, num_cars, steps=40, most=400):
    """_k2_state's drive, at least ``steps`` steps and on until the next
    step's Collide pass has a live point in some env (at most ``most``)."""
    cfg = EnvConfig(num_agents=num_cars, use_random_direction=False)
    state = penv.reset_batch(cfg, range(8), num_envs, device="cuda")
    act = torch.as_tensor(np.random.RandomState(1).uniform(
        [-1, 0, 0], [1, 1, 0.2], size=(num_envs, num_cars, 3)), dtype=torch.float32,
        device="cuda")
    for t in range(most):
        pre = apply_controls(state.cars, act)
        if t >= steps and bool(collide.collide(pre, num_cars).point_ok.any()):
            break
        state, _, _ = penv.step(cfg, state, act)
    return pre, state.wheel_on_road, state.contacts


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [10, 12])
def test_contact_kernels_past_shared_memory_match_plain(num_cars):
    """K2 and K3 at N = 10 and 12, where a warp's arrays (244,936 bytes at
    N = 10) do not fit the card's shared memory a block and live in a global
    scratch buffer: against island_step_plain and world.world_step after 40
    or more driven steps (until a live contact), within both bars; the
    wrapper chose the scratch; a launch forced onto 5 scratch slots (each
    warp looping over several envs) is byte-equal to it."""
    _need_card()
    pre, on_road, cs = _contact_state(48, num_cars)
    mm = cs.ids.shape[1]
    k, ks, kc = fused_world.island_step(pre, on_road, cs)
    p, ps, pc = fused_world.island_step_plain(pre, on_road, cs)
    torch.cuda.synchronize()
    assert int(fused_world.launch_contacts.near_count) > 0 and float(pc.normal_imp.max()) > 0
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", pc.tangent_imp, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((kc.ids != pc.ids).any(1).sum()) <= 1 and int((ks != ps).sum()) <= 1
    lib = fused_world._library(fused_world.CONTACT_KERNEL)
    assert lib.contact_island_scratch_warps(48, num_cars, mm) > 0
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs, num_cars)
    b = fused_world.launch_contacts(fin, ls_in, cs, num_cars, scratch_warps=5)
    for x, y in zip((a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
                    (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)):
        assert torch.equal(x, y)
    *_, post, force, motor, bundle, _, _ = _solve_from(pre, on_road, cs, num_cars)
    _assert_solve_bars(post, force, motor, bundle, num_cars)
    fin3, ls3 = fused_world.pack_solve_inputs(post, force, motor)
    a = fused_world.launch_solve(fin3, ls3, bundle, num_cars)
    b = fused_world.launch_solve(fin3, ls3, bundle, num_cars, scratch_warps=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [6, 8])
def test_contact_kernels_scratch_layout_matches_plain(num_cars):
    """Up to N = 9 the wrapper keeps a warp's arrays in shared memory; the
    global scratch layout, forced onto 5 slots, holds the plain versions'
    bars there too (it is another build of the same arithmetic: its fused
    multiply-adds may round a last bit differently from the shared build's,
    so the two are not compared byte for byte)."""
    _need_card()
    pre, on_road, cs = _contact_state(48, num_cars)
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    fout, ls_out, kc = fused_world.launch_contacts(fin, ls_in, cs, num_cars, scratch_warps=5)
    k, ks = fused_world.unpack_outputs(pre, fout, ls_out)
    p, ps, pc = fused_world.island_step_plain(pre, on_road, cs)
    torch.cuda.synchronize()
    assert float(pc.normal_imp.max()) > 0
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", pc.tangent_imp, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    *_, post, force, motor, bundle, _, _ = _solve_from(pre, on_road, cs, num_cars)
    fin3, ls3 = fused_world.pack_solve_inputs(post, force, motor)
    fout3, ls3_out, ni, ti = fused_world.launch_solve(fin3, ls3, bundle, num_cars,
                                                       scratch_warps=5)
    k3 = post.replace(**fused_world._solved_fields(fout3, ls3_out, 48, num_cars))
    p3, p_bundle = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p3, f), getattr(k3, f), getattr(post, f))
    _assert_bars("normal_imp", p_bundle.normal_imp, ni, bundle.normal_imp)
    _assert_bars("tangent_imp", p_bundle.tangent_imp, ti, bundle.tangent_imp)


def _struct_floats(name):
    """Floats (and ints) of ``struct name`` in csrc/car_chain.cuh: each
    declarator counts 1, or its array length."""
    src = (CSRC / "car_chain.cuh").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    return sum(int(m.group(2) or 1) for m in re.finditer(r"(\w+)(?:\[(\d+)\])?\s*[,;]", body))


@pytest.mark.parametrize("num_cars", [33, 64])
def test_contact_scratch_sizing_past_32_cars(num_cars):
    """Past 32 cars an env K2 and K3 carry several cars a lane (no card
    needed): fused_world.warp_floats is the kernels' count (the wide layout's
    lbody, lcount and car slots of a Car and a JointK, counted from
    csrc/car_chain.cuh, on top of N = 32's); scratch_slots takes the
    resident warps up to SCRATCH_SHARE of the card's memory and names its
    limit when one slot does not fit; the wrappers refuse a CPU tensor for
    its device, not for its car count."""
    mm = num_cars * (num_cars - 1) // 2 * 48
    assert fused_world.CAR_SLOT_FLOATS == _struct_floats("Car") + _struct_floats("JointK") == 139
    narrow = 15 * 5 * num_cars + 28 * mm + 4
    assert fused_world.warp_floats(num_cars) == narrow + mm + 5 * num_cars + 139 * num_cars
    assert 4 * fused_world.warp_floats(32) == 2676112 and 4 * fused_world.warp_floats(10) == 244936
    card = 80 * 2 ** 30
    slot = 4 * fused_world.warp_floats(num_cars)
    assert fused_world.scratch_slots(10 ** 6, num_cars, card) == card // 8 // slot
    assert fused_world.scratch_slots(64, num_cars, card) == 64
    with pytest.raises(ValueError, match="share"):
        fused_world.scratch_slots(64, num_cars, 7 * slot)
    assert num_cars < fused_world.max_contact_cars(card) == 1756
    assert fused_world.warp_floats(1757) > fused_world.MAX_SLOT_FLOATS
    z = torch.zeros((71, 2 * num_cars))
    with pytest.raises(ValueError, match="CUDA"):
        fused_world.launch_contacts(z, z, None, num_cars)
    with pytest.raises(ValueError, match="CUDA"):
        fused_world.launch_solve(z[:58], z, None, num_cars)


@pytest.mark.parametrize("kernel", ["track_pass", "paint_view"])
def test_track_and_paint_limits_are_the_kernel_sources(kernel):
    """The limits the wrappers raise by name, past which K4/K5 and K6 refuse
    to launch, are the kernel sources' (no card needed): K4/K5's 16-bit
    visitor counts and its bytes a tile and envs a block (1,228 tiles in 48
    KB); K6's 227 KB a block, which its layout of 1 KB or so a car fills at
    N = 181 with 384 tiles."""
    src = (CSRC / f"{kernel}.cu").read_text()

    def const(name):
        return int(re.search(r"constexpr int %s = ([^;]+);" % name, src).group(1).split("*")[0])

    if kernel == "track_pass":
        assert const("kMaxCars") == track_engine.TRACK_MAX_CARS == 65535
        assert const("kSmemPerTile") == track_engine.TRACK_SMEM_PER_TILE
        assert const("kEnvsPerBlock") == track_engine.TRACK_ENVS_PER_BLOCK
        assert track_engine.track_smem_bytes(1228) <= track_engine.TRACK_SMEM_LIMIT
        assert track_engine.track_smem_bytes(1229) > track_engine.TRACK_SMEM_LIMIT
    else:
        assert "kMaxCars" not in src and "227 * 1024" in src
        assert pixels.PAINT_SMEM_LIMIT == 227 * 1024
        assert const("kWarmW") == pixels.PAINT_WARM_WORDS
        assert pixels.max_paint_cars(384) == 180
        assert pixels.paint_smem_bytes(180, 384) <= pixels.PAINT_SMEM_LIMIT
        assert pixels.paint_smem_bytes(181, 384) > pixels.PAINT_SMEM_LIMIT
        # N = 2's tables, as the kernel's layout counts them word by word.
        assert pixels.paint_smem_bytes(2, 384) == 4 * (
            8 + 80 * 16 + 16 * 16 + 9 * 28 + 64 + 32 + 21 + 36 * (24 + 1 + 1) + 384 * 26)


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [33, 64])
def test_contact_kernels_past_32_cars_match_plain(num_cars):
    """K2 and K3 at N = 33 and 64, where a lane carries two cars (the wide
    instances): against island_step_plain and world.world_step after 10 or
    more driven steps (until a live contact), within both bars; the wrapper
    chose the scratch, and a launch forced onto 3 slots is byte-equal to
    it; two launches bit-identical. Then both on piled groups of four cars
    at rest (hundreds of live rows an env, past row 2^16 at N = 64)."""
    _need_card()
    pile = piled_groups(num_cars, 4, 5)
    pile = (tree_map(lambda x: x.cuda(), pile), torch.ones((4, num_cars, 4), dtype=torch.bool,
                                                          device="cuda"),
            collide.init_contact_state(4, num_cars, device="cuda"))
    k, ks, kc = fused_world.island_step(*pile)
    p, ps, pc = fused_world.island_step_plain(*pile)
    torch.cuda.synchronize()
    assert int(collide.collide(pile[0], num_cars).point_ok.any(-1).sum(1).min()) > 32
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pile[0], f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, pile[2].normal_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((kc.ids != pc.ids).any(1).sum()) <= 1 and int((ks != ps).sum()) <= 1
    *_, post, force, motor, bundle, _, _ = _solve_from(*pile, num_cars)
    _assert_solve_bars(post, force, motor, bundle, num_cars)

    pre, on_road, cs = _contact_state(16, num_cars, steps=10)
    k, ks, kc = fused_world.island_step(pre, on_road, cs)
    p, ps, pc = fused_world.island_step_plain(pre, on_road, cs)
    torch.cuda.synchronize()
    assert int(fused_world.launch_contacts.near_count) > 0 and float(pc.normal_imp.max()) > 0
    for f in CAR_FIELDS:
        _assert_bars(f, getattr(p, f), getattr(k, f), getattr(pre, f))
    _assert_bars("normal_imp", pc.normal_imp, kc.normal_imp, cs.normal_imp)
    _assert_bars("tangent_imp", pc.tangent_imp, kc.tangent_imp, cs.tangent_imp)
    assert torch.equal(k.limit_state, p.limit_state)
    assert int((kc.ids != pc.ids).any(1).sum()) <= 1 and int((ks != ps).sum()) <= 1
    fin, ls_in = fused_world.pack_inputs(pre, on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs, num_cars)
    b = fused_world.launch_contacts(fin, ls_in, cs, num_cars, scratch_warps=3)
    c = fused_world.launch_contacts(fin, ls_in, cs, num_cars)
    for x, y, z in zip(*((o[0], o[1], o[2].normal_imp, o[2].tangent_imp, o[2].ids)
                         for o in (a, b, c))):
        assert torch.equal(x, y) and torch.equal(x, z)
    *_, post, force, motor, bundle, _, _ = _solve_from(pre, on_road, cs, num_cars)
    _assert_solve_bars(post, force, motor, bundle, num_cars)
    fin3, ls3 = fused_world.pack_solve_inputs(post, force, motor)
    a = fused_world.launch_solve(fin3, ls3, bundle, num_cars)
    b = fused_world.launch_solve(fin3, ls3, bundle, num_cars, scratch_warps=3)
    c = fused_world.launch_solve(fin3, ls3, bundle, num_cars)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))


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
    pool = penv.make_host_track_pool(cfg, range(4), device="cuda")
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
    pool = penv.make_host_track_pool(cfg, range(8), device="cuda")
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
    # The caps left are its 16-bit visitor counts and the tiles whose arrays
    # fit its shared memory (1,228), named by the wrapper.
    extra = 1229 - track.max_tiles
    wide = tree_map(lambda x: torch.cat([x, x[..., -1:].expand(*x.shape[:-1], extra)], -1)
                    if x.dim() >= 2 and x.shape[-1] == track.max_tiles else x, track)
    vis = torch.zeros((4, 2, 1229), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        track_engine.track_pass(wide, pre, post, vis, vis[:, 0].contiguous(), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("num_cars", [33, 64])
def test_track_kernel_past_32_cars_matches_plain(num_cars):
    """K4/K5 at N = 33 and 64 (64 envs, 12 driven steps): the track bars
    against track_pass_plain, two launches bit-identical."""
    _need_card()
    args = _track_inputs(64, num_cars, 12)
    k = track_engine.track_pass(*args, num_cars)
    k2 = track_engine.track_pass(*args, num_cars)
    p = track_engine.track_pass_plain(*args, num_cars)
    torch.cuda.synchronize()
    _assert_track_bars(k, p, k2, f"N={num_cars}")
    assert bool(p[0].any()) and int(p[3].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("num_envs,num_cars", [
    (e, n) for n in (1, 2, 4) for e in (1, 37, 4096)] + [(3, 33), (2, 64)])
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
    # The one cap left is the views whose tables fit a block's shared memory
    # (180 cars at 384 tiles), named by the wrapper.
    E, mt = 1, args[6].shape[1]
    n = pixels.max_paint_cars(mt) + 1
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device="cuda")
    many = (z(E, n, 8), z(E, n, pixels.SQ, 16), z(E, n, 8 * n, 16), z(E, n, 4 * n, 28),
            z(E, n, 8, 8), z(E, n, 4, 8, dtype=torch.int32), z(E, mt, 4, 2), z(E, mt, 4, 2),
            *(z(E, mt, dtype=torch.bool) for _ in range(4)))
    with pytest.raises(ValueError, match="shared memory"):
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


# ------------------------------------------------------------------ the learner

POLICY_NAMES = ("carracing_v0_solved", "pixels_solved", "multi2p", "multi2px")


@pytest.mark.gpu
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_committed_policy_on_card_matches_cpu(name):
    """Each committed policy's network on the card (cuDNN's bf16 convolutions
    for the pixel torso) against the same policy on the CPU, on observations
    of 8 envs driven 5 steps on the card; tests/test_torch_networks.py's
    bars: 1e-5 * max(1, |x|) for the state nets, 1e-2 * max(1, max|CPU|) on
    mean and value for the pixel nets."""
    _need_card()
    from multi_car_racing_tpu_torch.learner import evaluate, ppo

    net, rms, env_cfg, flags, _ = evaluate.load_policy(name, "cuda")
    cpu_net = evaluate.load_policy(name, "cpu")[0]
    pcfg = ppo.PPOConfig(**flags)
    state = evaluate.episode_state(env_cfg, 8, 3, "cuda")
    obs_now = ppo._observe(env_cfg, pcfg, state)
    frames = ppo.init_frames(pcfg, obs_now)
    action = torch.tensor([0.0, 0.7, 0.0], device="cuda").expand(8, env_cfg.num_agents, 3)
    for _ in range(5):
        state, _, _ = penv.step(env_cfg, state, action)
        frames = ppo._push_frames(frames, obs_now)
        obs_now = ppo._observe(env_cfg, pcfg, state)
    obs = ppo._stack_obs(frames, obs_now)
    if rms is not None:
        obs = ppo._rms_normalize(rms, obs)
    with torch.no_grad():
        got = [t.detach().cpu() for t in net(obs)]
        want = [t.detach() for t in cpu_net(obs.cpu())]
    tol = 1e-2 if flags["obs_type"] == "pixels" else 1e-5
    for label, g, w in zip(("mean", "log_std", "value"), got, want):
        assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max())), label


@pytest.mark.gpu
@pytest.mark.parametrize("obs_type", ["state", "pixels"])
def test_train_step_on_card(obs_type):
    """One PPO train step at a small shape on the card: finite metrics, moved
    parameters, the state's kernels launched (no plain track pass or
    painter on the card)."""
    _need_card()
    from multi_car_racing_tpu_torch.learner import ppo

    cfg = EnvConfig(num_agents=2)
    pcfg = ppo.PPOConfig(rollout_len=4, num_envs=16, pool_size=4, minibatches=2, epochs=2,
                         obs_type=obs_type, frame_stack=2, action_repeat=2,
                         normalize_obs=obs_type == "state", train_skip_cost=2.0,
                         squash_actions=obs_type == "pixels")
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cuda")
    before = [p.detach().clone() for p in ts.net.parameters()]
    fused_world.island_step.contact_launches = track_engine.track_pass_plain.cuda_calls = 0
    pixels.paint_views_plain.cuda_calls = 0
    step = ppo.make_train_step(cfg, pcfg)
    ts, metrics = step(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert max(float((a - b.detach()).abs().max()) for a, b in
               zip(before, ts.net.parameters())) > 0
    assert fused_world.island_step.contact_launches == 4 * 2 + 1
    assert track_engine.track_pass_plain.cuda_calls == pixels.paint_views_plain.cuda_calls == 0
    assert set(ppo.stage_ms(step.marks)) == {"rollout", "gae", "update", "reset"}


@pytest.mark.gpu
def test_pixels_solved_evaluates_on_card():
    """Ten deterministic episodes of the committed pixel policy on the card:
    every episode ends (the lap or the time limit) and visits at least half
    of its track's tiles."""
    _need_card()
    from multi_car_racing_tpu_torch.learner import evaluate, ppo

    net, rms, env_cfg, flags, _ = evaluate.load_policy("pixels_solved", "cuda")
    pcfg = ppo.PPOConfig(num_envs=10, **flags)
    state = evaluate.episode_state(env_cfg, 10, 7, "cuda")
    out = evaluate.make_eval_fn(env_cfg, pcfg, 10)(net, rms, state)
    length = out["length"].cpu()
    frac = (out["tiles"][:, 0].float() / out["n_tiles"].float()).cpu()
    assert bool(((length > 100) & (length <= env_cfg.max_episode_steps)).all()), length
    assert float(frac.min()) >= 0.5, frac
    assert evaluate.summarize(out)["eval_return"] > 500


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,island", [("MultiCarRacing-v0", "contact_launches"),
                                           ("CarRacing-v0", "launches")])
def test_facade_steps_through_the_kernels_on_card(env_id, island):
    """The Gym facade on the card: each step launches its island kernel
    (K2 at two cars, K1 at one), the track pass and the painter once, and
    its observation equals the plain painter's on the same state."""
    _need_card()
    from multi_car_racing_tpu_torch import gym_api

    env = gym_api.make(env_id, verbose=0)
    env.seed(1)
    env.reset()
    counts = (getattr(fused_world.island_step, island), track_engine.track_pass.launches,
              pixels.paint_views.launches)
    for t in range(12):
        obs, r, done, _ = env.step(np.full((env.num_agents, 3), [0.1 * (t % 3 - 1), 0.8, 0.0]))
    after = (getattr(fused_world.island_step, island), track_engine.track_pass.launches,
             pixels.paint_views.launches)
    assert tuple(b - a for a, b in zip(counts, after)) == (12, 12, 12)
    plain = pixels.paint_views_plain(*pixels.paint_inputs(env.env.cfg, env.state))[0]
    assert np.array_equal(obs, plain.cpu().numpy()) and np.isfinite(r).all()


@pytest.mark.gpu
def test_rgb_array_painter_on_card_matches_golden_and_cpu():
    """The 600x400 painter on the card: the rgb_array_skid golden frame
    byte for byte, and the same frame as on the CPU for a moved-trails
    state."""
    _need_card()
    import json
    import os

    from multi_car_racing_tpu_torch import convert
    from multi_car_racing_tpu_torch.render import raster

    d = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden",
                             "rgb_array_skid.npz"))
    meta = json.loads(str(d["meta"]))
    leaves = [d[f"leaf_{i}"][None] for i in range(meta["n_leaves"])]
    cfg = EnvConfig(**meta["cfg"])
    card = convert.env_state_from_leaves(leaves, device="cuda")
    img = raster.render_observation(cfg, card, 600, 400, draw_particles=True)
    assert np.array_equal(img[0].cpu().numpy(), d["frame"])
    shift = torch.tensor([4.0, 3.0, 4.0, 3.0], device="cuda")
    seg = card.skid.seg.clone()
    for k in range(seg.shape[1]):
        ok = card.skid.valid[0, k]
        centre = card.cars.hull_origin[0, k].repeat(2) + shift
        seg[0, k] = seg[0, k] - seg[0, k, ok].mean(0) + centre
    moved = card.replace(skid=dataclasses.replace(card.skid, seg=seg))
    a = raster.render_observation(cfg, moved, 600, 400, draw_particles=True)[0].cpu().numpy()
    b = raster.render_observation(cfg, tree_map(lambda x: x.cpu(), moved), 600, 400,
                                  draw_particles=True)[0].numpy()
    assert np.array_equal(a, b) and not np.array_equal(a, d["frame"])
