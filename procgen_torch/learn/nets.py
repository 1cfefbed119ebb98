"""IMPALA CNN policy/value net (Espeholt et al. 2018), the architecture
train-procgen uses for the Procgen paper baselines (counterpart of
``procgen_tpu/learn/nets.py``).

Parameters stay float32, so the optimizer's math is exact.  The convolutions
and the 256-wide dense layer compute in ``dtype`` (bfloat16 by default) by
casting input, weight and bias, as flax's ``dtype=`` does; the two heads
compute in float32.  Activations run NCHW-shaped over channels-last memory:
the uint8 observations are NHWC, and ``permute`` makes them an NCHW view of
the same bytes, which is what cuDNN's bf16 convolutions prefer.

Initialisation follows flax: kernels are ``lecun_normal`` (a normal
truncated to two standard deviations, scaled to variance 1 / fan_in), biases
zero.  The port draws that distribution from its own generator, not flax's
bits; ``convert.impala_params_from_numpy`` carries flax's parameters over.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal on (-2, 2) standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """flax ``nn.Conv(c, (3, 3), padding="SAME", dtype=dtype)``: the product
    is rounded to ``dtype`` before the bias is added, as flax does (a bias
    fused into the convolution rounds once, a different bf16 function)."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=1)
    return y + conv.bias.to(dtype)[:, None, None]


def _linear(x: torch.Tensor, dense: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``, the bias added after the product."""
    return F.linear(x.to(dtype), dense.weight.to(dtype)) + dense.bias.to(dtype)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on an even
    side: XLA's SAME padding puts the one pad row and column after the input
    (pads (0, 1)), so the input is padded with -inf on the bottom and right
    and pooled without padding.  ``F.max_pool2d(padding=1)`` would shift
    every window by one pixel."""
    x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(channels, channels, 3, device=device)
        self.conv1 = nn.Conv2d(channels, channels, 3, device=device)

    def forward(self, x):
        y = _conv(F.relu(x), self.conv0, self.dtype)
        y = _conv(F.relu(y), self.conv1, self.dtype)
        return x + y


class ConvSequence(nn.Module):
    def __init__(self, in_channels: int, channels: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, channels, 3, device=device)
        self.res0 = ResidualBlock(channels, dtype, device)
        self.res1 = ResidualBlock(channels, dtype, device)

    def forward(self, x):
        x = max_pool_same(_conv(x, self.conv, self.dtype))
        return self.res1(self.res0(x))


class ImpalaCNN(nn.Module):
    """obs (N, 64, 64, 3) uint8 -> (logits (N, n_actions), value (N,)), both
    float32.  ``generator`` draws the initial parameters (on ``device``)."""

    def __init__(self, n_actions: int = 15, depths: Sequence[int] = (16, 32, 32),
                 dtype=torch.bfloat16, *, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        chans = (3, *depths)
        self.seqs = nn.ModuleList(
            ConvSequence(chans[i], chans[i + 1], dtype, device) for i in range(len(depths))
        )
        side = 64 // 2 ** len(depths)
        # rows of ``dense`` are ordered (h, w, c), as flax flattens NHWC
        self.dense = nn.Linear(side * side * depths[-1], 256, device=device)
        self.logits = nn.Linear(256, n_actions, device=device)
        self.value = nn.Linear(256, 1, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                lecun_normal_(m.weight, fan_in, generator)
                nn.init.zeros_(m.bias)

    def forward(self, obs: torch.Tensor):
        # obs.astype(dtype) / 255.0 divides in dtype; the divisor is a tensor
        # (CUDA's division by a scalar multiplies by its reciprocal)
        x = obs.to(self.dtype) / torch.full((), 255.0, dtype=self.dtype, device=obs.device)
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes
        for seq in self.seqs:
            x = seq(x)
        x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten NHWC
        # the heads in the parameters' dtype: float32, or float64 in a
        # float64 copy of the net (``.double()``, dtype float64)
        x = F.relu(_linear(x, self.dense, self.dtype)).to(self.logits.weight.dtype)
        logits = F.linear(x, self.logits.weight, self.logits.bias)
        value = F.linear(x, self.value.weight, self.value.bias)[:, 0]
        return logits, value
