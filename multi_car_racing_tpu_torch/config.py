"""Configuration for the PyTorch port of the multi-car racing engine.

Every constant mirrors the reference by name and value:
- env constants: the reference's gym_multi_car_racing/multi_car_racing.py:43-78 ("mcr")
- vehicle constants: gym car_dynamics.py:26-50 ("cd")

The reference spreads configuration over module-level constants, constructor
kwargs (mcr:131-133) and Gym registration kwargs (__init__.py:5-10). Here it is
a single frozen (hashable) dataclass.
"""

from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------------------
# Environment constants (mcr:43-78)
# ---------------------------------------------------------------------------
STATE_W = 96
STATE_H = 96
VIDEO_W = 600
VIDEO_H = 400
WINDOW_W = 1000
WINDOW_H = 800

SCALE = 6.0                   # Track scale (mcr:50)
TRACK_RAD = 900 / SCALE       # Track is heavily morphed circle with this radius
PLAYFIELD = 2000 / SCALE      # Game over boundary
FPS = 50                      # Physics/frame rate
ZOOM = 2.7                    # Camera zoom
ZOOM_FOLLOW = True

TRACK_DETAIL_STEP = 21 / SCALE
TRACK_TURN_RATE = 0.31
TRACK_WIDTH = 40 / SCALE
BORDER = 8 / SCALE
BORDER_MIN_COUNT = 4
CHECKPOINTS = 12              # mcr:184

ROAD_COLOR = (0.4, 0.4, 0.4)

CAR_COLORS = (
    (0.8, 0.0, 0.0), (0.0, 0.0, 0.8),
    (0.0, 0.8, 0.0), (0.0, 0.8, 0.8),
    (0.8, 0.8, 0.8), (0.0, 0.0, 0.0),
    (0.8, 0.0, 0.8), (0.8, 0.8, 0.0),
)

LINE_SPACING = 5              # Starting distance between each pair of cars
LATERAL_SPACING = 3           # Starting side distance between pairs of cars

BACKWARD_THRESHOLD = math.pi / 2
K_BACKWARD = 0.0              # Backward-driving penalty weight (disabled, mcr:78)

# Gym registration metadata (reference __init__.py:5-10)
MAX_EPISODE_STEPS = 1000
REWARD_THRESHOLD = 900.0

# ---------------------------------------------------------------------------
# Vehicle constants (cd:26-50)
# ---------------------------------------------------------------------------
SIZE = 0.02
ENGINE_POWER = 100000000 * SIZE * SIZE          # 4e4
WHEEL_MOMENT_OF_INERTIA = 4000 * SIZE * SIZE    # 1.6
FRICTION_LIMIT = 1000000 * SIZE * SIZE          # 400
GRASS_FRICTION_FACTOR = 0.6                     # cd:181
TIRE_STIFFNESS = 205000 * SIZE * SIZE           # slip-force gain (cd:228-229)
BRAKE_FORCE = 15.0                              # rad/s per unit brake (cd:212)
WHEEL_R = 27
WHEEL_W = 14
WHEELPOS = ((-55, +80), (+55, +80), (-55, -82), (+55, -82))
HULL_POLY1 = ((-60, +130), (+60, +130), (+60, +110), (-60, +110))
HULL_POLY2 = ((-15, +120), (+15, +120), (+20, +20), (-20, +20))
HULL_POLY3 = ((+25, +20), (+50, -10), (+50, -40), (+20, -90),
              (-20, -90), (-50, -40), (-50, -10), (-25, +20))
HULL_POLY4 = ((-50, -120), (+50, -120), (+50, -90), (-50, -90))
WHEEL_COLOR = (0.0, 0.0, 0.0)
WHEEL_WHITE = (77 / 255, 77 / 255, 77 / 255)
MUD_COLOR = (102 / 255, 102 / 255, 0.0)

# Revolute steering joint (cd:122-133)
STEER_JOINT_MAX_MOTOR_TORQUE = 180 * 900 * SIZE * SIZE  # 64.8
STEER_JOINT_LOWER = -0.4
STEER_JOINT_UPPER = +0.4
STEER_SERVO_GAIN = 50.0        # motorSpeed = sign * min(50*|err|, 3.0) (cd:175-177)
STEER_SERVO_MAX_SPEED = 3.0
GAS_RATE_LIMIT = 0.1           # max gas increase per control call (cd:150-151)

# Box2D solver parameters actually used by the reference (mcr:428)
DT = 1.0 / FPS
VELOCITY_ITERS = 6 * 30        # 180
POSITION_ITERS = 2 * 30        # 60
# Car-car contact sub-pass caps (physics/world.py). Full interleave by
# default: capping below the joint iteration count lets post-contact joint
# polishing reopen approach velocities and visibly changes crash outcomes
# (measured 20 m post-impact divergence at 30/20).
CONTACT_VELOCITY_ITERS = VELOCITY_ITERS
CONTACT_POSITION_ITERS = POSITION_ITERS

# Box2D internal tuning constants (b2Settings.h, Box2D 2.3.5) that shape the
# numerics we reproduce:
B2_LINEAR_SLOP = 0.005
B2_ANGULAR_SLOP = 2.0 / 180.0 * math.pi
B2_POLYGON_RADIUS = 2.0 * B2_LINEAR_SLOP      # polygon "skin"
B2_MAX_LINEAR_CORRECTION = 0.2
B2_MAX_ANGULAR_CORRECTION = 8.0 / 180.0 * math.pi
B2_BAUMGARTE = 0.2
B2_MAX_TRANSLATION = 2.0
B2_MAX_ROTATION = 0.5 * math.pi
B2_VELOCITY_THRESHOLD = 1.0
# Sensor overlap fires when the GJK gap is below the summed polygon skins;
# our SAT test uses this as its margin (see physics/overlap.py).
SENSOR_OVERLAP_MARGIN = 2.0 * B2_POLYGON_RADIUS

# Default friction of fixtures that don't set one (hull, tiles): 0.2.
HULL_FRICTION = 0.2
WHEEL_FIXTURE_DENSITY = 0.1
HULL_FIXTURE_DENSITY = 1.0

NUM_WHEELS = 4
REAR_WHEELS = (2, 3)           # gas applies to rear wheels only (cd:148)
FRONT_WHEELS = (0, 1)          # steer applies to front wheels (cd:168-169)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (frozen and hashable).

    The fields of the JAX package's ``EnvConfig`` that this slice of the port
    reads: the reference constructor kwargs that shape the physics and the
    episode (mcr:131-133), track padding and the solver iteration counts.
    ``track_skid`` and ``exact_hull_touch`` belong to the rendering slice;
    the env refuses them when set rather than ignoring them.
    """

    num_agents: int = 2
    direction: str = "CCW"            # 'CCW' or 'CW'
    use_random_direction: bool = True

    # --- engine knobs (new, no reference counterpart) ---
    max_tiles: int = 384              # pad track to this many tiles (measured max 355)
    exact_hull_touch: bool = False    # full hull SAT for the render 'touched' flag
    track_skid: bool = False          # maintain skid-particle trails (render-only)
    velocity_iters: int = VELOCITY_ITERS
    position_iters: int = POSITION_ITERS

    def __post_init__(self):
        if self.direction not in ("CCW", "CW"):
            raise ValueError(f"direction must be 'CCW' or 'CW', got {self.direction!r}")
        if self.num_agents < 1:
            raise ValueError("num_agents must be >= 1")
