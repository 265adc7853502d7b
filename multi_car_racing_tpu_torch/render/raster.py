"""Palette and tile-window constants of the pixel painter.

Copies of the JAX package's ``render/raster.py:36-80`` (the port imports
nothing of that package). Every colour the 96x96 scene can produce lives in
one static palette, road dither levels included: the painter paints palette
indices and expands them to RGB once at the end.

The XLA painter of that module (``render_observation``, an arbitrary
viewport with skid particles, for ``render("rgb_array")``) is not ported
yet; the observation contract is ``pixels.render_pixels``.
"""

from __future__ import annotations

import numpy as np

from .. import config as C

W1 = 32   # primary tile window
W2 = 8    # secondary window (crossing sections)
WS = W1 + W2

PAL_WHITE = 0        # clear color / curb white / HUD white / score
PAL_GRASS_DARK = 1
PAL_GRASS_LIGHT = 2
PAL_ROAD0 = 3        # road + 0.00 dither == flattened "touched" color
PAL_ROAD1 = 4
PAL_ROAD2 = 5
PAL_RED = 6          # curb red / gyro bar red
PAL_BLACK = 7        # wheel / HUD bar black
PAL_WHEEL_WHITE = 8
PAL_CAR0 = 9         # 8 car colors: 9..16 (CAR_COLORS; ego red/blue reuse 9/10)
PAL_ABS_BLUE = 17    # (0, 0, 1): ABS bars front, backwards flag
PAL_ABS_BLUE2 = 18   # (0.2, 0, 1): ABS bars rear
PAL_GREEN = 19       # steering bar
PAL_MUD = 20         # skid particles on grass (rgb_array mode)

PALETTE = np.array(
    [
        (1.0, 1.0, 1.0),
        (0.4, 0.8, 0.4),
        (0.4, 0.9, 0.4),
        (0.4, 0.4, 0.4),
        (0.41, 0.41, 0.41),
        (0.42, 0.42, 0.42),
        (1.0, 0.0, 0.0),
        (0.0, 0.0, 0.0),
        C.WHEEL_WHITE,
    ]
    + list(C.CAR_COLORS)
    + [
        (0.0, 0.0, 1.0),
        (0.2, 0.0, 1.0),
        (0.0, 1.0, 0.0),
        C.MUD_COLOR,
    ],
    dtype=np.float32,
)
PALETTE_U8 = np.round(np.clip(PALETTE, 0, 1) * 255).astype(np.uint8)
