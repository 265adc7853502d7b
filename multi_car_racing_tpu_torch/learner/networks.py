"""Actor-critic networks, port of the JAX package's ``learner/networks.py``.

Two torsos:
- ``state``: an MLP over the 38-d state-vector observation (``obs.py``),
  float32 throughout.
- ``pixels``: the Nature CNN over the 96x96x3K uint8 frames (K stacked
  frames, channels last as the env gives them). Its three convolutions and
  its 512-unit Dense compute in bfloat16 from float32 parameters, exactly as
  the JAX torso does: the frames are cast to bfloat16 *before* the division
  by 255, each layer's weight and bias are cast to bfloat16, and the torso's
  output is cast back to float32 ahead of the heads.

The heads and ``log_std`` are float32; no TF32 may touch them (on CUDA the
forward refuses to run with ``torch.backends.cuda.matmul.allow_tf32`` set).
One shared policy for all agents: inputs are batched over any leading dims
(envs, agents) and the network is agnostic to them.

Parameters are initialised as flax initialises them, from an explicit
``torch.Generator``: ``orthogonal(sqrt 2)`` for the state torso,
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
a standard deviation of sqrt(1/fan_in)) for every convolution and the pixel
Dense, ``orthogonal(0.01)`` for the mean head, ``orthogonal(1)`` for the
value head, ``log_std`` -0.5, every bias zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..obs import STATE_OBS_DIM

FRAME_HW = 96
FRAME_CHANNELS = 3
# (out channels, kernel, stride) of the Nature CNN's three convolutions.
CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
PIXEL_DENSE = 512
# The pixel torso's compute dtype, JAX's. Set to float32, it takes bfloat16's
# rounding out of a comparison of two batch layouts (tests/test_torch_ppo.py).
PIXEL_COMPUTE_DTYPE = torch.bfloat16
# Standard deviation of a unit normal truncated to [-2, 2]: lecun_normal
# divides by it so that the truncated draw has the variance asked for.
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_geometry() -> tuple[list[int], int]:
    """Each convolution's symmetric padding, and the flattened torso width."""
    pads, size = [], FRAME_HW
    for _, k, s in CONVS:
        lo, hi = same_padding(size, k, s)
        if lo != hi:
            raise ValueError(f"'SAME' padding ({lo}, {hi}) is not symmetric: conv2d "
                             "cannot express it")
        pads.append(lo)
        size = -(-size // s)
    return pads, size * size * CONVS[-1][0]


PADDINGS, FLAT_DIM = _conv_geometry()      # [2, 1, 1], 12 * 12 * 64 = 9216


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _orthogonal(layer: nn.Linear, gain: float, generator: torch.Generator) -> nn.Linear:
    nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class StateTorso(nn.Module):
    def __init__(self, obs_dim: int, width: int, generator: torch.Generator):
        super().__init__()
        self.fc0 = _orthogonal(nn.Linear(obs_dim, width), math.sqrt(2.0), generator)
        self.fc1 = _orthogonal(nn.Linear(width, width), math.sqrt(2.0), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.fc1(torch.tanh(self.fc0(x))))


class PixelTorso(nn.Module):
    """Nature CNN, bfloat16 compute from float32 parameters."""

    def __init__(self, in_channels: int, generator: torch.Generator):
        super().__init__()
        convs, c = [], in_channels
        for out, k, s in CONVS:
            conv = nn.Conv2d(c, out, k, stride=s)
            lecun_normal_(conv.weight, c * k * k, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            c = out
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(FLAT_DIM, PIXEL_DENSE)
        lecun_normal_(self.fc.weight, FLAT_DIM, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (..., 96, 96, C) uint8, channels last.
        lead = x.shape[:-3]
        bf = PIXEL_COMPUTE_DTYPE
        h = x.reshape((-1,) + tuple(x.shape[-3:])).to(bf) / 255.0   # cast, then divide
        h = h.permute(0, 3, 1, 2)                                    # NCHW for conv2d
        for conv, (_, _, s), pad in zip(self.convs, CONVS, PADDINGS):
            h = F.relu(F.conv2d(h, conv.weight.to(bf), conv.bias.to(bf), stride=s,
                                padding=pad))
        # Flatten in flax's NHWC order: the Dense rows are (h, w, c)-major.
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = F.relu(F.linear(h, self.fc.weight.to(bf), self.fc.bias.to(bf)))
        return h.float().reshape(lead + (PIXEL_DENSE,))


class ActorCritic(nn.Module):
    """(mean, log_std broadcast to mean's shape, value) of a shared policy.

    ``obs_type`` 'state' takes (..., 38) float32 features, 'pixels' takes
    (..., 96, 96, 3 * frame_stack) uint8 frames."""

    def __init__(self, obs_type: str = "state", width: int = 256, frame_stack: int = 1,
                 action_dim: int = 3, generator: torch.Generator | None = None):
        super().__init__()
        if obs_type not in ("state", "pixels"):
            raise ValueError(f"obs_type must be 'state' or 'pixels', got {obs_type!r}")
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.obs_type, self.width, self.frame_stack = obs_type, width, frame_stack
        if obs_type == "state":
            self.torso = StateTorso(STATE_OBS_DIM, width, g)
            hidden = width
        else:
            self.torso = PixelTorso(FRAME_CHANNELS * frame_stack, g)
            hidden = PIXEL_DENSE
        self.mean_head = _orthogonal(nn.Linear(hidden, action_dim), 0.01, g)
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))
        self.value_head = _orthogonal(nn.Linear(hidden, 1), 1.0, g)

    def forward(self, obs: torch.Tensor):
        if obs.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("ActorCritic: TF32 matmuls are enabled; the float32 layers "
                               "must not run in TF32")
        h = self.torso(obs)
        mean = self.mean_head(h)
        value = self.value_head(h)
        return mean, self.log_std.expand_as(mean), value[..., 0]
