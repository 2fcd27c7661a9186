"""Inception V3: port of ``horovod_tpu/models/inception.py``.

Every convolution is a :class:`ConvBN` (``Conv_0`` without bias, the zoo's
BatchNorm ``BatchNorm_0`` with epsilon 1e-3 and momentum 0.9, ReLU), named
``ConvBN_<i>`` in call order inside each block as flax names them.
Activations are in ``dtype`` and channels-last; the head is fp32.  Inputs
are NCHW images of 75 px or more (299 for the benchmark).  ``bn_sync=True``
takes the BatchNorm statistics over the global batch (the reference's
``bn_axis_name``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..sync_batch_norm import BatchNorm, name_batch_norms
from ._layers import conv, make_conv, make_dense, spatial_mean


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel, strides=(1, 1),
                 padding="SAME", dtype: torch.dtype = torch.float32,
                 bn_sync: bool = False):
        super().__init__()
        self.padding, self.dtype = padding, dtype
        self.Conv_0 = make_conv(cin, features, tuple(kernel), tuple(strides))
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, eps=1e-3,
                                     dtype=dtype, sync=bn_sync)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(
            conv(x, self.Conv_0, self.dtype, self.padding)))


def _avg_pool_same(x):
    # flax avg_pool(3x3, stride 1, "SAME") divides by the full window.
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _Block(nn.Module):
    """Named ConvBN layers built in call order; ``out`` channels."""

    def __init__(self, conv_bn):
        super().__init__()
        self._conv_bn, self._n = conv_bn, 0

    def _c(self, cin, features, kernel, **kw):
        layer = self._conv_bn(cin, features, kernel, **kw)
        self.add_module(f"ConvBN_{self._n}", layer)
        self._n += 1
        return layer


class InceptionA(_Block):
    def __init__(self, cin, pool_features, conv_bn):
        super().__init__(conv_bn)
        c = self._c
        self.b1 = [c(cin, 64, (1, 1))]
        self.b2 = [c(cin, 48, (1, 1)), c(48, 64, (5, 5))]
        self.b3 = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)), c(96, 96, (3, 3))]
        self.b4 = [c(cin, pool_features, (1, 1))]
        self.out = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          _seq(self.b3, x),
                          _seq(self.b4, _avg_pool_same(x))], dim=1)


class InceptionB(_Block):
    def __init__(self, cin, conv_bn):
        super().__init__(conv_bn)
        c = self._c
        self.b1 = [c(cin, 384, (3, 3), strides=(2, 2), padding="VALID")]
        self.b2 = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)),
                   c(96, 96, (3, 3), strides=(2, 2), padding="VALID")]
        self.out = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin, c7, conv_bn):
        super().__init__(conv_bn)
        c = self._c
        self.b1 = [c(cin, 192, (1, 1))]
        self.b2 = [c(cin, c7, (1, 1)), c(c7, c7, (1, 7)), c(c7, 192, (7, 1))]
        self.b3 = [c(cin, c7, (1, 1)), c(c7, c7, (7, 1)), c(c7, c7, (1, 7)),
                   c(c7, c7, (7, 1)), c(c7, 192, (1, 7))]
        self.b4 = [c(cin, 192, (1, 1))]
        self.out = 4 * 192

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          _seq(self.b3, x),
                          _seq(self.b4, _avg_pool_same(x))], dim=1)


class InceptionD(_Block):
    def __init__(self, cin, conv_bn):
        super().__init__(conv_bn)
        c = self._c
        self.b1 = [c(cin, 192, (1, 1)),
                   c(192, 320, (3, 3), strides=(2, 2), padding="VALID")]
        self.b2 = [c(cin, 192, (1, 1)), c(192, 192, (1, 7)),
                   c(192, 192, (7, 1)),
                   c(192, 192, (3, 3), strides=(2, 2), padding="VALID")]
        self.out = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([_seq(self.b1, x), _seq(self.b2, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin, conv_bn):
        super().__init__(conv_bn)
        c = self._c
        # Lists, not attributes: the layers are registered as ConvBN_<i>.
        self.b1 = [c(cin, 320, (1, 1))]
        self.b2 = [c(cin, 384, (1, 1))]
        self.b2_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b3 = [c(cin, 448, (1, 1)), c(448, 384, (3, 3))]
        self.b3_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b4 = [c(cin, 192, (1, 1))]
        self.out = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b2 = _seq(self.b2, x)
        b3 = _seq(self.b3, x)
        return torch.cat([_seq(self.b1, x), *(f(b2) for f in self.b2_split),
                          *(f(b3) for f in self.b3_split),
                          _seq(self.b4, _avg_pool_same(x))], dim=1)


def _seq(layers, x):
    for layer in layers:
        x = layer(x)
    return x


class InceptionV3(nn.Module):
    """Inception V3 over NCHW images ``[B, 3, H, W]``, H and W >= 75;
    fp32 logits."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, bn_sync: bool = False):
        super().__init__()
        self.dtype = dtype
        cb = functools.partial(ConvBN, dtype=dtype, bn_sync=bn_sync)
        self.stem = []
        stem = [(3, 32, (3, 3), (2, 2), "VALID"),
                (32, 32, (3, 3), (1, 1), "VALID"),
                (32, 64, (3, 3), (1, 1), "SAME"), "pool",
                (64, 80, (1, 1), (1, 1), "VALID"),
                (80, 192, (3, 3), (1, 1), "VALID"), "pool"]
        i = 0
        for spec in stem:
            if spec == "pool":
                self.stem.append(None)
                continue
            cin, f, k, s, pad = spec
            self.add_module(f"ConvBN_{i}",
                            cb(cin, f, k, strides=s, padding=pad))
            self.stem.append(f"ConvBN_{i}")
            i += 1
        blocks = [("InceptionA_0", InceptionA, (32,)),
                  ("InceptionA_1", InceptionA, (64,)),
                  ("InceptionA_2", InceptionA, (64,)),
                  ("InceptionB_0", InceptionB, ()),
                  ("InceptionC_0", InceptionC, (128,)),
                  ("InceptionC_1", InceptionC, (160,)),
                  ("InceptionC_2", InceptionC, (160,)),
                  ("InceptionC_3", InceptionC, (192,)),
                  ("InceptionD_0", InceptionD, ()),
                  ("InceptionE_0", InceptionE, ()),
                  ("InceptionE_1", InceptionE, ())]
        cin = 192
        self.blocks = []
        for name, cls, args in blocks:
            block = cls(cin, *args, cb)
            self.add_module(name, block)
            self.blocks.append(name)
            cin = block.out
        self.head = make_dense(cin, num_classes)
        self.to(memory_format=torch.channels_last)
        name_batch_norms(self)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for name in self.stem:
            x = F.max_pool2d(x, 3, 2) if name is None \
                else getattr(self, name)(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = spatial_mean(x)
        return F.linear(x.float(), self.head.weight, self.head.bias)
