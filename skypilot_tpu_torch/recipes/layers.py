"""What the small recipes' modules (``mnist``, ``glue_imdb``,
``resnet_ddp``) share with the JAX package's flax modules beyond torch's
own layers: flax's default initialisers and its ``"SAME"`` padding.

Flax draws a ``Dense`` or ``Conv`` kernel from ``lecun_normal`` (a normal
truncated at two standard deviations, rescaled to variance 1 / fan_in)
and zeroes its bias; torch's layers draw a uniform of a third of that
variance and a uniform bias. The recipes draw flax's way, so that they
train as the JAX recipes do (the numbers differ from JAX's PRNG).

``"SAME"`` pads a dim of size n, for a window k at stride s, by
``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, the smaller half
before: asymmetric when that total is odd (a 7x7 stride-2 conv on 224
pads (2, 3), a 3x3 stride-2 one on an even size (0, 1)). A symmetric
``padding=`` gives the same output shape over windows shifted by one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]: lecun
# normal divides by it so that the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` into ``w``, in place."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Every ``nn.Linear`` and ``nn.Conv2d`` under ``module`` drawn as
    flax draws ``Dense`` and ``Conv``: lecun normal kernel, zero bias.
    Norms keep torch's ones and zeros, which are flax's."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of ``"SAME"`` on a dim of size n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` padded for a k x k window at stride s, ``"SAME"``."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class SameConv2d(nn.Conv2d):
    """A square ``nn.Conv2d`` with flax's ``"SAME"`` padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size[0],
                                        self.stride[0]))
