"""Layers the ported model zoo shares: flax's convolution padding and
initializers, and its per-module dtype casts.

flax ``nn.Conv(dtype=d)`` and ``nn.Dense(dtype=d)`` keep fp32 parameters
and cast input and parameters to ``d`` for the product, so the activations
are in ``d``; :func:`conv` and :func:`linear` do the same with every cast
written out (no autocast, whose per-op lists differ).  The CNNs keep their
4-D tensors in the channels-last memory format (NCHW logical shapes):
cuDNN's fast path on the card.  flax's
``padding="SAME"`` pads ``max((out - 1) * stride + k - size, 0)`` in all,
the smaller half before: a 3x3 convolution of stride 2 on an even size pads
(0, 1), where ``nn.Conv2d(padding=1)`` would pad (1, 1).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Pads = Union[str, Sequence[Tuple[int, int]]]

LN_EPS = 1e-6  # flax.linen.LayerNorm's default

# flax's lecun_normal and variance_scaling(.., "truncated_normal") draw from
# a normal truncated at two standard deviations, rescaled by this constant
# so the variance is the requested one.
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
         padding: Pads = "SAME") -> torch.Tensor:
    """flax ``nn.Conv`` over an NCHW tensor: ``padding`` is ``"SAME"``,
    ``"VALID"`` or explicit ``[(lo, hi), (lo, hi)]`` for H and W."""
    kh, kw = layer.kernel_size
    sh, sw = layer.stride
    if padding == "SAME":
        padding = [_same_pads(x.shape[2], kh, sh),
                   _same_pads(x.shape[3], kw, sw)]
    elif padding == "VALID":
        padding = [(0, 0), (0, 0)]
    (t, b), (l, r) = padding
    x = x.to(dtype)
    if t == b and l == r:
        pad = (t, l)
    else:
        x, pad = F.pad(x, (l, r, t, b)), (0, 0)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x, layer.weight.to(dtype), bias, layer.stride, pad)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype)``: input and parameters cast first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype):
    """LayerNorm in fp32 (flax's ``nn.LayerNorm(dtype=jnp.float32)``), the
    output cast back to ``dtype``."""
    return ln(x.float()).to(dtype)


def lecun_normal_(w: torch.Tensor, fan_in: int):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def make_conv(cin: int, cout: int, k: Tuple[int, int],
              stride: Tuple[int, int] = (1, 1), bias: bool = False,
              init: str = "lecun") -> nn.Conv2d:
    """An ``nn.Conv2d`` holding a flax ``nn.Conv``'s parameters, initialized
    as flax does: ``lecun_normal`` (its default) or ``"fan_out"``, the
    ResNet's ``variance_scaling(2, "fan_out", "normal")``; zero bias."""
    layer = nn.Conv2d(cin, cout, k, stride, bias=bias)
    if init == "fan_out":
        std = math.sqrt(2.0 / (cout * k[0] * k[1]))
        with torch.no_grad():
            layer.weight.normal_(0.0, std)
    else:
        lecun_normal_(layer.weight, cin * k[0] * k[1])
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def make_dense(cin: int, cout: int) -> nn.Linear:
    """An ``nn.Linear`` initialized as flax ``nn.Dense``: lecun_normal
    weight, zero bias."""
    layer = nn.Linear(cin, cout)
    lecun_normal_(layer.weight, cin)
    nn.init.zeros_(layer.bias)
    return layer


def make_embed(num: int, features: int) -> nn.Embedding:
    """flax ``nn.Embed``'s init: normal with std ``1/sqrt(features)``."""
    layer = nn.Embedding(num, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, 1.0 / math.sqrt(features))
    return layer


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over H and W, accumulated in fp32 as JAX does for a
    16-bit input, in the input's dtype."""
    return x.float().mean((2, 3)).to(x.dtype)
