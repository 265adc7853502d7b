"""Track generation on the device: the procedural track, batched over tracks.

Port of the JAX package's ``track/device.py``: the algorithm of the host
generator (``track/host.py`` = mcr:183-338) as fixed-bound tensor code over
a leading axis of P tracks: a 2500-step walk, masked closed-loop extraction,
vectorized curb marking (with the reference's negative-index smear quirk),
and rejection-resampling retries. JAX leaves this module to XLA; here it is
plain torch ops, run on whatever device the generator lives on.

Random draws come from an explicit ``torch.Generator``: (P, 12, 2) uniforms
per attempt, in place of JAX's threefry keys. Device tracks are therefore
statistically identical to the reference's, not bit-identical (the host
generator keeps the MT19937 stream); given the same uniforms
(``checkpoints_from_uniforms``) the two packages agree to float32 noise.
Everything is float32, as JAX runs with x64 off, the walk's accumulation of
x, y and beta included. No matmul touches a position: the SAT projection is
written as products and sums.

Tracks longer than ``max_tiles`` are rejected and resampled like glue
failures. The walk is ~60 small launches per step on a card (~1.5e5 per
attempt round); nothing in it reads the device from the host, and the retry
loop reads one flag vector per round.
"""

from __future__ import annotations

import math

import torch

from .. import config as C
from .common import Track, _PAD_FAR

TWO_PI = 2 * math.pi


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as a true float32 division: on CUDA, dividing by a Python
    scalar multiplies by its reciprocal, which may lose a bit."""
    return torch.div(a, torch.tensor(b, dtype=a.dtype, device=a.device))


def checkpoints_from_uniforms(u: torch.Tensor):
    """mcr:186-198 from the attempt's uniforms ``u`` (P, 12, 2), both drawn for
    every checkpoint: (alpha, x, y), each (P, 12) float32."""
    ncp = C.CHECKPOINTS
    c = torch.arange(ncp, dtype=torch.float32, device=u.device)
    alpha = _div(TWO_PI * c, ncp) + u[..., 0] * (TWO_PI / ncp)
    rad = C.TRACK_RAD / 3 + u[..., 1] * (C.TRACK_RAD - C.TRACK_RAD / 3)
    alpha[:, 0] = 0.0
    alpha[:, ncp - 1] = TWO_PI * (ncp - 1) / ncp
    rad[:, 0] = 1.5 * C.TRACK_RAD
    rad[:, ncp - 1] = 1.5 * C.TRACK_RAD
    return alpha, rad * torch.cos(alpha), rad * torch.sin(alpha)


def _checkpoints(generator: torch.Generator, count: int):
    """One attempt's checkpoints for ``count`` tracks, from (count, 12, 2)
    uniforms drawn from ``generator`` on its device."""
    u = torch.rand((count, C.CHECKPOINTS, 2), generator=generator, device=generator.device)
    return checkpoints_from_uniforms(u)


def _dest_scan(dest_i: torch.Tensor, alpha: torch.Tensor, cp_alpha: torch.Tensor):
    """The destination scan of one walk step (mcr:221-234): dest_i advances
    while alpha > cp_alpha[dest_i % 12], alpha losing 2 pi each time dest_i
    reaches a multiple of 12. Returns (dest_i, alpha) after it.

    The scan ends within 12 advances: alpha enters in [0, 2 pi], so at the
    first multiple of 12 it is at most 0 = cp_alpha[0]. The 13 candidate
    stops are therefore computed at once and the first taken, which equals
    JAX's ``lax.while_loop`` without a loop on the host."""
    k = torch.arange(C.CHECKPOINTS + 1, device=dest_i.device)
    di = dest_i[:, None] + k                                     # (P, 13)
    wrapped = torch.div(di, C.CHECKPOINTS, rounding_mode="floor") > torch.div(
        dest_i, C.CHECKPOINTS, rounding_mode="floor")[:, None]
    al = torch.where(wrapped, (alpha - TWO_PI)[:, None], alpha[:, None])
    stop = al <= torch.gather(cp_alpha, 1, di % C.CHECKPOINTS)
    first = stop.to(torch.uint8).argmax(dim=1, keepdim=True)    # the first stop; k = 12 always is
    return dest_i + first[:, 0], torch.gather(al, 1, first)[:, 0]


def _walk(cp_alpha: torch.Tensor, cp_x: torch.Tensor, cp_y: torch.Tensor, max_points: int):
    """The integrator walk (mcr:206-259) for P tracks, ``max_points`` steps.

    Returns (alpha, beta_mid, x, y, active), each (P, max_points); entries
    where ``active`` is False lie past the walk's end."""
    P, dev, f32 = cp_alpha.shape[0], cp_alpha.device, torch.float32
    x = torch.full((P,), 1.5 * C.TRACK_RAD, dtype=f32, device=dev)
    y = torch.zeros(P, dtype=f32, device=dev)
    beta = torch.zeros(P, dtype=f32, device=dev)
    dest_i = torch.zeros(P, dtype=torch.int64, device=dev)
    laps = torch.zeros(P, dtype=torch.int32, device=dev)
    visited = torch.zeros(P, dtype=torch.bool, device=dev)
    active = torch.ones(P, dtype=torch.bool, device=dev)
    out = ([], [], [], [], [])
    for _ in range(max_points):
        alpha = torch.atan2(y, x)
        lap_cross = visited & (alpha > 0)
        laps = laps + lap_cross
        behind = alpha < 0
        visited = (visited & ~lap_cross) | behind
        alpha = torch.where(behind, alpha + TWO_PI, alpha)
        dest_i, alpha = _dest_scan(dest_i, alpha, cp_alpha)
        dest = (dest_i % C.CHECKPOINTS)[:, None]
        dest_x = torch.gather(cp_x, 1, dest)[:, 0]
        dest_y = torch.gather(cp_y, 1, dest)[:, 0]

        r1x, r1y = torch.cos(beta), torch.sin(beta)
        proj = r1x * (dest_x - x) + r1y * (dest_y - y)

        # beta unwinding (mcr:242-245): closed form of the repeated +-2 pi.
        db = beta - alpha
        beta = beta - TWO_PI * torch.ceil(_div(db - 1.5 * math.pi, TWO_PI)).clamp(min=0)
        db = beta - alpha
        beta = beta + TWO_PI * torch.ceil(_div(-db - 1.5 * math.pi, TWO_PI)).clamp(min=0)

        prev_beta = beta
        proj = proj * C.SCALE
        turn = torch.abs(0.001 * proj).clamp(max=C.TRACK_TURN_RATE)
        beta = torch.where(proj > 0.3, beta - turn, beta)
        beta = torch.where(proj < -0.3, beta + turn, beta)
        x = x + -r1y * C.TRACK_DETAIL_STEP
        y = y + r1x * C.TRACK_DETAIL_STEP
        for acc, v in zip(out, (alpha, 0.5 * (prev_beta + beta), x, y, active)):
            acc.append(v)
        active = active & (laps <= 4)
    return tuple(torch.stack(acc, dim=1) for acc in out)


def _attempt(cp_alpha: torch.Tensor, cp_x: torch.Tensor, cp_y: torch.Tensor, max_tiles: int,
             max_points: int):
    """One generation attempt for P tracks from their checkpoints. Returns
    (t_beta, t_x, t_y (P, MT) float32, valid (P, MT) bool, L (P,) int32,
    ok (P,) bool)."""
    alpha, beta, x, y, active = _walk(cp_alpha, cp_x, cp_y, max_points)
    P, MT = max_points, max_tiles
    dev = alpha.device
    start_alpha = TWO_PI * (-0.5) / C.CHECKPOINTS

    # Closed-loop extraction (mcr:263-281): the last two start_alpha crossings.
    i = torch.arange(P, device=dev)
    prev_alpha = torch.cat([alpha[:, :1], alpha[:, :-1]], dim=1)
    cross = (alpha > start_alpha) & (prev_alpha <= start_alpha) & active & (i >= 1)
    ci = torch.where(cross, i, -1)
    i2 = ci.max(dim=1).values
    i1 = torch.where(ci < i2[:, None], ci, -1).max(dim=1).values
    ok = (i1 > 0) & (i2 > 0)
    span = i2 - 1 - i1
    L = span.clamp(0, MT)
    ok = ok & (L > 0) & (span <= MT)

    # The slice [i1, i1 + MT) of the walk padded with MT zeros, as JAX's
    # dynamic_slice takes it: a negative start wraps, then clamps into range.
    start = torch.where(i1 < 0, i1 + P + MT, i1).clamp(0, P)
    idx = start[:, None] + torch.arange(MT, device=dev)

    def sl(a):
        return torch.gather(torch.cat([a, a.new_zeros((a.shape[0], MT))], dim=1), 1, idx)

    t_beta, t_x, t_y = sl(beta), sl(x), sl(y)
    valid = torch.arange(MT, device=dev) < L[:, None]

    # Glue check (mcr:283-291); the index L - 1 as JAX's dynamic_index takes it.
    fpx, fpy = torch.cos(t_beta[:, 0]), torch.sin(t_beta[:, 0])
    last = torch.where(L < 1, L - 1 + MT, L - 1).clamp(0, MT - 1)[:, None]
    lx = torch.gather(t_x, 1, last)[:, 0]
    ly = torch.gather(t_y, 1, last)[:, 0]
    glue = torch.sqrt(torch.square(fpx * (t_x[:, 0] - lx)) + torch.square(fpy * (t_y[:, 0] - ly)))
    ok = ok & (glue <= C.TRACK_DETAIL_STEP)
    return t_beta, t_x, t_y, valid, L.to(torch.int32), ok


def _mod_take(a: torch.Tensor, idx: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """a[p, idx mod max(L_p, 1)] for every track p; idx (MT,)."""
    return torch.gather(a, 1, torch.remainder(idx[None, :], L.clamp(min=1)[:, None].long()))


def _borders(t_beta: torch.Tensor, L: torch.Tensor, max_tiles: int) -> torch.Tensor:
    """Curb marking (mcr:294-307), vectorized: (P, MT) bool. Includes the
    in-place smear's negative-index wrap quirk (head good values leak to the
    tail, then smear backwards from there; see track/host.py)."""
    mt = max_tiles
    i = torch.arange(mt, device=t_beta.device)
    Lb = L[:, None]
    good = torch.ones_like(t_beta, dtype=torch.bool)
    oneside = torch.zeros_like(t_beta)
    for neg in range(C.BORDER_MIN_COUNT):
        b1 = _mod_take(t_beta, i - neg, L)
        b2 = _mod_take(t_beta, i - neg - 1, L)
        good = good & (torch.abs(b1 - b2) > C.TRACK_TURN_RATE * 0.2)
        oneside = oneside + torch.sign(b1 - b2)
    good = good & (torch.abs(oneside) == C.BORDER_MIN_COUNT) & (i < Lb)

    # wrap_in[L-m] = OR of good[0..3-m] for m = 1..3.
    g0, g1, g2 = good[:, 0:1], good[:, 1:2], good[:, 2:3]
    wrap = (((i == Lb - 1) & (g0 | g1 | g2)) | ((i == Lb - 2) & (g0 | g1))
            | ((i == Lb - 3) & g0))
    read = good | wrap

    border = torch.zeros_like(good)
    for k in range(C.BORDER_MIN_COUNT):
        shifted = torch.cat([read[:, k:], torch.zeros_like(read[:, :k])], dim=1)
        border = border | (shifted & ((i + k) < Lb))
    return border


def _build_track(t_beta: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor,
                 valid: torch.Tensor, L: torch.Tensor, max_tiles: int) -> Track:
    """Tile and curb geometry (mcr:309-334) of P tracks from their extracted
    points: every field of :class:`Track`, contiguous in the layout of
    ``pack_track_arrays``, so the track pass and the painter read device
    tracks as they read host tracks."""
    mt, dev, f32 = max_tiles, t_beta.device, torch.float32
    i = torch.arange(mt, device=dev)
    xy1 = torch.stack([t_x, t_y], dim=-1)                                  # (P, MT, 2)
    prev = torch.remainder(i[None, :] - 1, L.clamp(min=1)[:, None].long())
    beta1 = t_beta
    beta2 = torch.gather(t_beta, 1, prev)
    xy2 = torch.gather(xy1, 1, prev[..., None].expand(-1, -1, 2))

    def offs(beta, k):
        return torch.stack([k * torch.cos(beta), k * torch.sin(beta)], dim=-1)

    w = C.TRACK_WIDTH
    quad = torch.stack([xy1 - offs(beta1, w), xy1 + offs(beta1, w),
                        xy2 + offs(beta2, w), xy2 - offs(beta2, w)], dim=2)  # [r1_l, r1_r, r2_r, r2_l]
    far = torch.tensor(_PAD_FAR, dtype=f32, device=dev)
    quad = torch.where(valid[..., None, None], quad, far)

    dither = 0.01 * (i % 3).to(f32)
    color0 = (torch.tensor(C.ROAD_COLOR, dtype=f32, device=dev)[None, :] + dither[:, None])
    color0 = color0.expand(t_beta.shape[0], -1, -1).contiguous()

    border = _borders(t_beta, L, mt)
    side = torch.sign(beta2 - beta1)
    b = C.BORDER
    curb = torch.stack([xy1 + offs(beta1, side * w), xy1 + offs(beta1, side * (w + b)),
                        xy2 + offs(beta2, side * (w + b)), xy2 + offs(beta2, side * w)], dim=2)
    curb = torch.where((valid & border)[..., None, None], curb, far)

    # Tiles-last layouts + SAT precompute (mirrors pack_track_arrays).
    edges = torch.roll(quad, -1, dims=2) - quad
    nrm = torch.stack([edges[..., 1], -edges[..., 0]], dim=-1)
    ln = torch.sqrt(nrm[..., 0] * nrm[..., 0] + nrm[..., 1] * nrm[..., 1])[..., None]
    nrm = torch.where(ln > 1e-12, nrm / ln.clamp(min=1e-12),
                      torch.tensor([1.0, 0.0], dtype=f32, device=dev))
    # proj[p, t, a, v] = nrm[p, t, a] . quad[p, t, v], products and sums only.
    proj = (nrm[..., :, None, 0] * quad[..., None, :, 0]
            + nrm[..., :, None, 1] * quad[..., None, :, 1])

    def tiles_last(a):
        return a.permute(0, *range(2, a.dim()), 1).contiguous()

    return Track(
        n_tiles=L.to(torch.int32).contiguous(),
        valid=valid.contiguous(),
        xy=torch.where(valid[..., None], xy1, far).contiguous(),
        beta=t_beta.contiguous(),
        quad=quad.contiguous(),
        color0=color0,
        has_curb=(border & valid).contiguous(),
        curb_quad=curb.contiguous(),
        curb_red=(i % 2 != 0).expand(t_beta.shape[0], -1).contiguous(),
        quad_T=tiles_last(quad),
        quad_ax_T=tiles_last(nrm),
        quad_lo=tiles_last(proj.min(dim=-1).values),
        quad_hi=tiles_last(proj.max(dim=-1).values),
        curb_quad_T=tiles_last(curb),
    )


def generate_tracks(generator: torch.Generator, count: int, max_tiles: int = 384,
                    max_points: int = 2500, max_retries: int = 12):
    """``count`` tracks on the generator's device, each retried with fresh
    uniforms until an attempt succeeds or ``max_retries`` attempts have
    failed (mcr:359-364, bounded). Only the tracks still failing run again;
    each keeps its last attempt. Returns (Track of E = count, ok (count,)
    bool)."""
    dev, f32 = generator.device, torch.float32
    t_beta = torch.zeros((count, max_tiles), dtype=f32, device=dev)
    t_x, t_y = torch.zeros_like(t_beta), torch.zeros_like(t_beta)
    valid = torch.zeros((count, max_tiles), dtype=torch.bool, device=dev)
    L = torch.zeros(count, dtype=torch.int32, device=dev)
    ok = torch.zeros(count, dtype=torch.bool, device=dev)
    todo = torch.arange(count, device=dev)
    for _ in range(max_retries):
        if todo.numel() == 0:
            break
        parts = _attempt(*_checkpoints(generator, todo.numel()), max_tiles, max_points)
        for dst, src in zip((t_beta, t_x, t_y, valid, L, ok), parts):
            dst.index_copy_(0, todo, src)
        todo = todo[~parts[-1]]                  # the round's one read on the host
    return _build_track(t_beta, t_x, t_y, valid, L.clamp(min=1), max_tiles), ok
