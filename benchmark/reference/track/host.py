# Frozen copy of multi_car_racing_tpu_torch/track/host.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Host ("oracle") track generator — bit-parity with the reference.

Reproduces ``MultiCarRacing._create_track`` (mcr:183-338) numerically exactly:
same RNG draw order (24 uniforms per attempt from the hash-seeded MT19937
stream, consumed even for the pinned first/last checkpoints), same float64
scalar math via the C libm (``math.sin``/``atan2``), same loop-extraction and
glue-rejection rules, same curb marking including the negative-index wrap
quirk in the backwards smear (mcr:305-307).

This is a verbatim copy of the JAX package's generator, kept here so that the
PyTorch port imports nothing of that package; the port's tests hold the two
equal bit for bit. Its output is packed by ``track/common.py`` and fed to the
batched env on the device.
"""

from __future__ import annotations

import math

import numpy as np

from .. import config as C


def generate_track_attempt(rng: np.random.RandomState):
    """One generation attempt. Returns (track_pts (T,4) f64, border (T,) bool)
    or None on rejection (caller retries with the same advancing RNG stream,
    matching mcr:359-364)."""
    # --- Checkpoints (mcr:186-198). Both uniforms are drawn for every
    # checkpoint, including the two pinned ones, so the stream advances
    # identically.
    ncp = C.CHECKPOINTS
    checkpoints = []
    start_alpha = 2 * math.pi * (-0.5) / ncp
    for c in range(ncp):
        alpha = 2 * math.pi * c / ncp + rng.uniform(0, 2 * math.pi * 1 / ncp)
        rad = rng.uniform(C.TRACK_RAD / 3, C.TRACK_RAD)
        if c == 0:
            alpha = 0
            rad = 1.5 * C.TRACK_RAD
        if c == ncp - 1:
            alpha = 2 * math.pi * c / ncp
            rad = 1.5 * C.TRACK_RAD
        checkpoints.append((alpha, rad * math.cos(alpha), rad * math.sin(alpha)))

    # --- Integrator walk (mcr:206-259): a virtual vehicle at (1.5R, 0)
    # heading beta=0 steps TRACK_DETAIL_STEP along its perpendicular each
    # iteration, steering toward the currently-targeted checkpoint.
    x, y, beta = 1.5 * C.TRACK_RAD, 0.0, 0.0
    dest_i = 0
    laps = 0
    track: list[tuple[float, float, float, float]] = []
    no_freeze = 2500
    visited_other_side = False
    while True:
        alpha = math.atan2(y, x)
        if visited_other_side and alpha > 0:
            laps += 1
            visited_other_side = False
        if alpha < 0:
            visited_other_side = True
            alpha += 2 * math.pi
        # Select destination checkpoint: first one with dest_alpha >= alpha,
        # scanning forward; a full wrap of the checkpoint ring unwinds alpha
        # by 2*pi and rescans (mcr:221-234).
        while True:
            failed = True
            while True:
                dest_alpha, dest_x, dest_y = checkpoints[dest_i % ncp]
                if alpha <= dest_alpha:
                    failed = False
                    break
                dest_i += 1
                if dest_i % ncp == 0:
                    break
            if not failed:
                break
            alpha -= 2 * math.pi
        r1x, r1y = math.cos(beta), math.sin(beta)
        p1x, p1y = -r1y, r1x
        dest_dx = dest_x - x
        dest_dy = dest_y - y
        proj = r1x * dest_dx + r1y * dest_dy
        while beta - alpha > 1.5 * math.pi:
            beta -= 2 * math.pi
        while beta - alpha < -1.5 * math.pi:
            beta += 2 * math.pi
        prev_beta = beta
        proj *= C.SCALE
        if proj > 0.3:
            beta -= min(C.TRACK_TURN_RATE, abs(0.001 * proj))
        if proj < -0.3:
            beta += min(C.TRACK_TURN_RATE, abs(0.001 * proj))
        x += p1x * C.TRACK_DETAIL_STEP
        y += p1y * C.TRACK_DETAIL_STEP
        track.append((alpha, prev_beta * 0.5 + beta * 0.5, x, y))
        if laps > 4:
            break
        no_freeze -= 1
        if no_freeze == 0:
            break

    # --- Closed-loop extraction (mcr:263-281): last two crossings of
    # start_alpha scanned from the tail; keep the second lap.
    i1, i2 = -1, -1
    i = len(track)
    while True:
        i -= 1
        if i == 0:
            return None  # Failed
        pass_through_start = (
            track[i][0] > start_alpha and track[i - 1][0] <= start_alpha
        )
        if pass_through_start and i2 == -1:
            i2 = i
        elif pass_through_start and i1 == -1:
            i1 = i
            break
    assert i1 != -1
    assert i2 != -1
    track = track[i1 : i2 - 1]
    if len(track) == 0:
        return None

    # --- Glue check (mcr:283-291).
    first_beta = track[0][1]
    first_perp_x = math.cos(first_beta)
    first_perp_y = math.sin(first_beta)
    well_glued_together = np.sqrt(
        np.square(first_perp_x * (track[0][2] - track[-1][2]))
        + np.square(first_perp_y * (track[0][3] - track[-1][3]))
    )
    if well_glued_together > C.TRACK_DETAIL_STEP:
        return None

    # --- Red-white curb marking (mcr:294-307). Python negative indices wrap
    # to the tail; the backwards smear mutates in place while iterating
    # forward, so tail entries set via negative wrap can propagate — list
    # semantics preserved verbatim.
    T = len(track)
    border = [False] * T
    for i in range(T):
        good = True
        oneside = 0.0
        for neg in range(C.BORDER_MIN_COUNT):
            beta1 = track[i - neg - 0][1]
            beta2 = track[i - neg - 1][1]
            good &= abs(beta1 - beta2) > C.TRACK_TURN_RATE * 0.2
            oneside += np.sign(beta1 - beta2)
        good &= abs(oneside) == C.BORDER_MIN_COUNT
        border[i] = good
    for i in range(T):
        for neg in range(C.BORDER_MIN_COUNT):
            border[i - neg] |= border[i]

    return np.asarray(track, dtype=np.float64), np.asarray(border, dtype=bool)


def generate_track(
    rng: np.random.RandomState, max_retries: int = 100
) -> tuple[np.ndarray, np.ndarray, int]:
    """Retry until success like mcr:359-364 (but bounded).

    Returns (track_pts, border, n_retries)."""
    for attempt in range(max_retries):
        out = generate_track_attempt(rng)
        if out is not None:
            return out[0], out[1], attempt
    raise RuntimeError(f"track generation failed {max_retries} times")

