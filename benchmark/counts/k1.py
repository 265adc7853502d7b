"""Work of K1 (``csrc/joints_island.cu``, the one-car island) on one step's data.

Frozen copy of ``island_flops`` and ``island_bytes`` of
``multi_car_racing_tpu_torch/physics/fused_world.py`` (commit 3d8d1d4), the
operations and bytes that the step's data needs, whatever the kernel's
launch shape. fp32 operations per car, counted from the kernel's arithmetic:
an add, multiply, compare, select, min or max counts 1; a division, square
root, sine or cosine counts 8. Joints whose limit is active take the longer
velocity path (the 3x3 solve) and the position limit correction.
"""

WHEN = "step"
KERNELS = ("joints_island_kernel",)

N_IN, N_OUT = 71, 59                # packed input and output rows per car
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


def island_flops(n_cars: int, n_limit_joints: int, velocity_iters: int,
                 position_iters: int) -> int:
    """fp32 operations of one island call over ``n_cars`` cars of which
    ``n_limit_joints`` joints (summed over cars) solve with an active limit."""
    return (n_cars * FLOPS_PER_CAR_FIXED
            + velocity_iters * (4 * FLOPS_VEL_JOINT * n_cars
                                + FLOPS_VEL_JOINT_LIMIT_EXTRA * n_limit_joints)
            + position_iters * (4 * FLOPS_POS_JOINT * n_cars
                                + FLOPS_POS_JOINT_LIMIT_EXTRA * n_limit_joints))


def island_bytes(n_cars: int) -> int:
    """Each packed input read once, each output written once (floats plus
    the int32 limit states)."""
    return n_cars * 4 * (N_IN + 4 + N_OUT + 4)


def limit_joints(post) -> int:
    """Joints that solved with an active limit: the step's output limit
    states, which the solve sets at its start."""
    return int((post.cars.limit_state != 0).sum())


def work(step) -> tuple[int, int]:
    """(fp32 operations, bytes) of one step's island over every car."""
    cfg = step.cfg
    n_cars = step.pre.cars.hull_a.numel()
    flops = island_flops(n_cars, limit_joints(step.post), cfg.velocity_iters,
                         cfg.position_iters)
    return flops, island_bytes(n_cars)
