"""The fused physics stage of a step at one car per env: the joints-only island.

``island_step`` runs, for every (env, car), the tire model, force
integration, the joint limit init and the 180-velocity / 60-position
Gauss-Seidel island solve. On CUDA tensors it launches the hand-written
kernel ``csrc/joints_island.cu`` (which replaces the TPU kernel
``multi_car_racing_tpu/physics/pallas_world.py::_make_mega_kernel`` with
``force_no_contacts=True``); on CPU tensors it runs ``island_step_plain``,
the same function as ``tire_step -> world_step`` in PyTorch ops. There is no
fallback from one to the other: a CUDA tensor either goes through the kernel
or raises.

``island_step.launches`` counts kernel launches (and nothing else), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import config as C
from . import joints, shapes, tire, world
from .state import CarState

KERNEL = "joints_island"

# Row offsets of the packed (rows, E*N) buffers; equal to the constexprs at
# the top of csrc/joints_island.cu.
IN_ROWS = dict(IN_HULL=0, IN_WHEEL=6, IN_TIRE=30, IN_FUEL=50, IN_ONROAD=51,
               IN_JNT=55, N_IN=71)
OUT_ROWS = dict(OUT_HULL=0, OUT_WHEEL=6, OUT_JNT=30, OUT_TIRE=46, OUT_FUEL=58,
                N_OUT=59)

# Scalar parameters in the order of the kernel's ``enum Param``.
PARAM_NAMES = (
    "DT", "MA", "IA", "MB", "IB", "MOTOR_MASS", "MA_MB", "IA_IB",
    "ARM_X0", "ARM_X1", "ARM_X2", "ARM_X3",
    "ARM_Y0", "ARM_Y1", "ARM_Y2", "ARM_Y3",
    "WHEEL_RAD", "MAX_MOTOR", "SERVO_GAIN", "SERVO_MAX",
    "FRICTION", "FRICTION_GRASS", "DT_ENGINE", "WHEEL_I", "BRAKE_FORCE",
    "TIRE_STIFFNESS", "LOWER", "UPPER", "ANG_SLOP", "MAX_ANG_CORR",
    "MAX_TRANS", "MAX_TRANS2", "MAX_ROT", "MAX_ROT2", "DT_MB",
)


def param_values() -> tuple:
    """The kernel's scalar parameters (float64 here, float32 on the card)."""
    dt = C.DT
    ma, ia = float(shapes.HULL_INV_MASS), float(shapes.HULL_INV_I)
    mb, ib = float(shapes.WHEEL_INV_MASS), float(shapes.WHEEL_INV_I)
    v = dict(
        DT=dt, MA=ma, IA=ia, MB=mb, IB=ib, MOTOR_MASS=1.0 / (ia + ib),
        MA_MB=ma + mb, IA_IB=ia + ib,
        WHEEL_RAD=float(shapes.WHEEL_RAD),
        MAX_MOTOR=dt * C.STEER_JOINT_MAX_MOTOR_TORQUE,
        SERVO_GAIN=C.STEER_SERVO_GAIN, SERVO_MAX=C.STEER_SERVO_MAX_SPEED,
        FRICTION=C.FRICTION_LIMIT,
        FRICTION_GRASS=C.FRICTION_LIMIT * C.GRASS_FRICTION_FACTOR,
        DT_ENGINE=dt * C.ENGINE_POWER, WHEEL_I=C.WHEEL_MOMENT_OF_INERTIA,
        BRAKE_FORCE=C.BRAKE_FORCE, TIRE_STIFFNESS=C.TIRE_STIFFNESS,
        LOWER=C.STEER_JOINT_LOWER, UPPER=C.STEER_JOINT_UPPER,
        ANG_SLOP=C.B2_ANGULAR_SLOP, MAX_ANG_CORR=C.B2_MAX_ANGULAR_CORRECTION,
        MAX_TRANS=C.B2_MAX_TRANSLATION, MAX_TRANS2=C.B2_MAX_TRANSLATION ** 2,
        MAX_ROT=C.B2_MAX_ROTATION, MAX_ROT2=C.B2_MAX_ROTATION ** 2,
        DT_MB=dt * mb,
    )
    for k in range(4):
        v[f"ARM_X{k}"] = joints.ARM_X[k]
        v[f"ARM_Y{k}"] = joints.ARM_Y[k]
    return tuple(v[name] for name in PARAM_NAMES)


# fp32 operations per car, counted from csrc/joints_island.cu: an add,
# multiply, compare, select, min or max counts 1; a division, square root,
# sine or cosine counts 8. Joints whose limit is active take the longer
# velocity path (the 3x3 solve) and the position limit correction.
FLOPS_PER_CAR_FIXED = (4 * 117      # tire model, per wheel (2 sin/cos, 3 div, 1 sqrt)
                       + 4 * 5      # limit-state init
                       + 16 + 4 * 22  # anchor arms (sin/cos) + warm start
                       + 4 * 63     # K-matrix terms and inverses
                       + 5 * 14     # translation/rotation clamps (unclamped path)
                       + 30)        # position integration
FLOPS_VEL_JOINT = 48                # one joint, one velocity iteration, limit inactive
FLOPS_VEL_JOINT_LIMIT_EXTRA = 15    # ... extra when the limit is active
FLOPS_POS_JOINT = 77                # one joint, one position iteration (2 sin/cos, 1 div)
FLOPS_POS_JOINT_LIMIT_EXTRA = 4


def island_flops(n_cars: int, n_limit_joints: int,
                 velocity_iters: int = C.VELOCITY_ITERS,
                 position_iters: int = C.POSITION_ITERS) -> int:
    """fp32 operations of one island call over ``n_cars`` cars of which
    ``n_limit_joints`` joints (summed over cars) start the solve with an
    active limit: the work this call's data needs."""
    return (n_cars * FLOPS_PER_CAR_FIXED
            + velocity_iters * (4 * FLOPS_VEL_JOINT * n_cars
                                + FLOPS_VEL_JOINT_LIMIT_EXTRA * n_limit_joints)
            + position_iters * (4 * FLOPS_POS_JOINT * n_cars
                                + FLOPS_POS_JOINT_LIMIT_EXTRA * n_limit_joints))


def island_bytes(n_cars: int) -> int:
    """Bytes the island must move: each packed input read once, each output
    written once (floats plus the int32 limit states)."""
    return n_cars * 4 * (IN_ROWS["N_IN"] + 4 + OUT_ROWS["N_OUT"] + 4)


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------

def island_step_plain(cars: CarState, wheel_on_road: torch.Tensor,
                      velocity_iters: int = C.VELOCITY_ITERS,
                      position_iters: int = C.POSITION_ITERS):
    """tire_step -> init_constraints -> world_step in PyTorch ops.

    Returns (new CarState, skid (E, N, 4) bool)."""
    cars, force, motor, skid = tire.tire_step(cars, wheel_on_road)
    new_cars = world.world_step(cars, force, motor,
                                velocity_iters=velocity_iters,
                                position_iters=position_iters)
    return new_cars, skid


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------

_params_cache: dict = {}


def _library():
    from .. import _cuda

    lib = _cuda.load(KERNEL)
    fn = lib.joints_island_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
        lib.joints_island_error_string.argtypes = [ci]
        lib.joints_island_error_string.restype = ctypes.c_char_p
    return lib


def _params(device: torch.device) -> torch.Tensor:
    key = str(device)
    if key not in _params_cache:
        _params_cache[key] = torch.tensor(param_values(), dtype=torch.float32,
                                          device=device)
    return _params_cache[key]


def _check(cars: CarState, wheel_on_road: torch.Tensor):
    E, N = cars.hull_a.shape
    dev = cars.hull_a.device
    float_shapes = dict(hull_c=(E, N, 2), hull_a=(E, N), hull_v=(E, N, 2),
                        hull_w=(E, N), wheel_c=(E, N, 4, 2), wheel_a=(E, N, 4),
                        wheel_v=(E, N, 4, 2), wheel_w=(E, N, 4),
                        joint_impulse=(E, N, 4, 3), motor_impulse=(E, N, 4),
                        gas=(E, N, 4), brake=(E, N, 4), steer=(E, N, 4),
                        spin=(E, N, 4), phase=(E, N, 4), fuel_spent=(E, N))
    for name, shape in float_shapes.items():
        t = getattr(cars, name)
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"island_step: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, want in (("limit_state", cars.limit_state, torch.int32),
                          ("wheel_on_road", wheel_on_road, torch.bool)):
        if t.dtype != want or t.device != dev or tuple(t.shape) != (E, N, 4):
            raise ValueError(f"island_step: {name} must be {want} {(E, N, 4)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return E, N


def pack_inputs(cars: CarState, wheel_on_road: torch.Tensor):
    """CarState -> the kernel's (71, E*N) float32 rows and (4, E*N) int32
    limit states, both contiguous, car index e*N + n."""
    E, N = cars.hull_a.shape

    def w4(x):                                   # (E, N, 4) -> (4, E, N)
        return x.permute(2, 0, 1)

    fin = torch.cat([
        cars.hull_v.permute(2, 0, 1), cars.hull_w[None],
        cars.hull_c.permute(2, 0, 1), cars.hull_a[None],
        w4(cars.wheel_v[..., 0]), w4(cars.wheel_v[..., 1]), w4(cars.wheel_w),
        w4(cars.wheel_c[..., 0]), w4(cars.wheel_c[..., 1]), w4(cars.wheel_a),
        w4(cars.gas), w4(cars.brake), w4(cars.steer), w4(cars.spin),
        w4(cars.phase), cars.fuel_spent[None],
        w4(wheel_on_road.to(torch.float32)),
        w4(cars.joint_impulse[..., 0]), w4(cars.joint_impulse[..., 1]),
        w4(cars.joint_impulse[..., 2]), w4(cars.motor_impulse),
    ]).reshape(IN_ROWS["N_IN"], E * N)
    ls_in = w4(cars.limit_state).reshape(4, E * N).contiguous()
    return fin.contiguous(), ls_in


def unpack_outputs(cars: CarState, fout: torch.Tensor, ls_out: torch.Tensor):
    """The kernel's output rows -> (new CarState, skid (E, N, 4) bool)."""
    E, N = cars.hull_a.shape
    fo = fout.view(OUT_ROWS["N_OUT"], E, N)

    def w4(r):                                   # rows r..r+3 -> (E, N, 4)
        return fo[r:r + 4].permute(1, 2, 0)

    def w4x2(r):                                 # rows r..r+7 -> (E, N, 4, 2)
        return fo[r:r + 8].view(2, 4, E, N).permute(2, 3, 1, 0)

    h, w, j, t = (OUT_ROWS["OUT_HULL"], OUT_ROWS["OUT_WHEEL"],
                  OUT_ROWS["OUT_JNT"], OUT_ROWS["OUT_TIRE"])
    new = cars.replace(
        hull_v=fo[h:h + 2].permute(1, 2, 0), hull_w=fo[h + 2],
        hull_c=fo[h + 3:h + 5].permute(1, 2, 0), hull_a=fo[h + 5],
        wheel_v=w4x2(w), wheel_w=w4(w + 8),
        wheel_c=w4x2(w + 12), wheel_a=w4(w + 20),
        joint_impulse=fo[j:j + 12].view(3, 4, E, N).permute(2, 3, 1, 0),
        motor_impulse=w4(j + 12),
        limit_state=ls_out.view(4, E, N).permute(1, 2, 0),
        spin=w4(t), phase=w4(t + 4),
        fuel_spent=fo[OUT_ROWS["OUT_FUEL"]],
    )
    return new, w4(t + 8) > 0.5


def launch(fin: torch.Tensor, ls_in: torch.Tensor, n_cars: int,
           velocity_iters: int = C.VELOCITY_ITERS,
           position_iters: int = C.POSITION_ITERS):
    """Launch the kernel on packed rows (from :func:`pack_inputs`) on the
    current stream; returns the packed outputs (fout (59, n), ls_out (4, n)).
    Counts the launch in ``island_step.launches``."""
    dev = fin.device
    if (fin.dtype != torch.float32 or ls_in.dtype != torch.int32 or dev.type != "cuda"
            or ls_in.device != dev or not fin.is_contiguous() or not ls_in.is_contiguous()
            or tuple(fin.shape) != (IN_ROWS["N_IN"], n_cars)
            or tuple(ls_in.shape) != (4, n_cars)):
        raise ValueError("launch: expects contiguous CUDA float32 (71, n) rows and "
                         "int32 (4, n) limit states")
    lib = _library()
    fout = torch.empty((OUT_ROWS["N_OUT"], n_cars), dtype=torch.float32, device=dev)
    ls_out = torch.empty((4, n_cars), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):      # the stream and the launch belong to dev
        rc = lib.joints_island_launch(
            fin.data_ptr(), ls_in.data_ptr(), fout.data_ptr(), ls_out.data_ptr(),
            _params(dev).data_ptr(), n_cars, int(velocity_iters), int(position_iters),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.joints_island_error_string(rc).decode()
        raise RuntimeError(f"joints_island launch failed: {msg} ({rc})")
    island_step.launches += 1
    return fout, ls_out


def island_step(cars: CarState, wheel_on_road: torch.Tensor,
                velocity_iters: int = C.VELOCITY_ITERS,
                position_iters: int = C.POSITION_ITERS):
    """The joints-only island for every (env, car): kernel on CUDA tensors,
    ``island_step_plain`` on CPU tensors. Returns (new CarState, skid)."""
    dev = cars.hull_a.device
    if dev.type == "cpu":
        return island_step_plain(cars, wheel_on_road, velocity_iters,
                                 position_iters)
    if dev.type != "cuda":
        raise ValueError(f"island_step: unsupported device {dev}")
    E, N = _check(cars, wheel_on_road)
    fin, ls_in = pack_inputs(cars, wheel_on_road)
    fout, ls_out = launch(fin, ls_in, E * N, velocity_iters, position_iters)
    return unpack_outputs(cars, fout, ls_out)


island_step.launches = 0
