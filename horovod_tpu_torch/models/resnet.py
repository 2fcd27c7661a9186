"""ResNet family (v1.5): port of ``horovod_tpu/models/resnet.py``.

The flax model is NHWC; this one takes NCHW images and keeps activations
and 4-D parameters in the channels-last memory format, cuDNN's fast path.
Activations are in ``dtype`` (bf16 for the benchmark), parameters fp32,
the classifier head fp32.  The stride of a bottleneck block sits on its
3x3 convolution (v1.5), and convolutions pad as flax's ``"SAME"``
(:mod:`._layers`).  Initializers are the reference's:
``variance_scaling(2, "fan_out", "normal")`` for convolutions, flax Dense's
for the head, and a zero scale for the last BatchNorm of every block.

Normalization is the zoo's :class:`..sync_batch_norm.BatchNorm` (flax
semantics: momentum 0.9, biased running variance, epsilon 1e-5);
``bn_sync=True`` takes its statistics over the global batch, as
``bn_axis_name`` does in the reference, through collectives named by each
layer's module path.  Module names follow the flax tree
(``conv_init``, ``bn_init``, ``BottleneckResNetBlock_<i>.Conv_<j>``, ...)
so ``models.convert`` maps one onto the other.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..sync_batch_norm import BatchNorm, name_batch_norms
from ._layers import conv, make_conv, make_dense, spatial_mean


class _Block(nn.Module):
    """A chain of (conv, norm) pairs with ReLU between them, added to the
    input or, where the shape changes, to its projection (``conv_proj``,
    ``norm_proj``)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int, norm,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        convs = self._convs(filters, strides)
        for j, (cout, k, stride) in enumerate(convs):
            self.add_module(f"Conv_{j}", make_conv(
                cin if j == 0 else convs[j - 1][0], cout, (k, k),
                (stride, stride), init="fan_out"))
            self.add_module(f"BatchNorm_{j}",
                            norm(cout, zero_scale=j == len(convs) - 1))
        self.n = len(convs)
        out = filters * self.expansion
        self.has_proj = strides != 1 or cin != out
        if self.has_proj:
            self.conv_proj = make_conv(cin, out, (1, 1), (strides, strides),
                                       init="fan_out")
            self.norm_proj = norm(out)

    def forward(self, x):
        y = x
        for j in range(self.n):
            y = getattr(self, f"BatchNorm_{j}")(
                conv(y, getattr(self, f"Conv_{j}"), self.dtype))
            if j < self.n - 1:
                y = F.relu(y)
        residual = x
        if self.has_proj:
            residual = self.norm_proj(conv(x, self.conv_proj, self.dtype))
        return F.relu(residual + y)


class ResNetBlock(_Block):
    """Basic residual block (ResNet-18/34)."""

    @staticmethod
    def _convs(filters, strides):
        return [(filters, 3, strides), (filters, 3, 1)]


class BottleneckResNetBlock(_Block):
    """Bottleneck residual block (ResNet-50/101/152), v1.5: the stride is
    on the 3x3 convolution."""

    expansion = 4

    @staticmethod
    def _convs(filters, strides):
        return [(filters, 1, 1), (filters, 3, strides), (filters * 4, 1, 1)]


class ResNet(nn.Module):
    """ResNet v1.5 over NCHW images (``[B, 3, H, W]``); fp32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, bn_sync: bool = False,
                 bn_momentum: float = 0.9, bn_epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        norm = functools.partial(BatchNorm, momentum=bn_momentum,
                                 eps=bn_epsilon, dtype=dtype, sync=bn_sync)
        self.conv_init = make_conv(3, num_filters, (7, 7), (2, 2),
                                   init="fan_out")
        self.bn_init = norm(num_filters)
        self.blocks = []
        cin, i_block = num_filters, 0
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = 2 if i > 0 and j == 0 else 1
                block = block_cls(cin, num_filters * 2 ** i, strides, norm,
                                  dtype)
                name = f"{block_cls.__name__}_{i_block}"
                self.add_module(name, block)
                self.blocks.append(name)
                cin = num_filters * 2 ** i * block_cls.expansion
                i_block += 1
        self.head = make_dense(cin, num_classes)
        self.to(memory_format=torch.channels_last)
        name_batch_norms(self)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = conv(x, self.conv_init, self.dtype, padding=[(3, 3), (3, 3)])
        x = F.relu(self.bn_init(x))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = spatial_mean(x)
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckResNetBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckResNetBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3],
                              block_cls=BottleneckResNetBlock)
# Tiny variant for tests and CPU dry runs: the same topology, 1/4 width.
ResNetTiny = functools.partial(ResNet, stage_sizes=[1, 1, 1, 1],
                               block_cls=ResNetBlock, num_filters=16)
