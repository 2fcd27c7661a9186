"""VGG-16/19: port of ``horovod_tpu/models/vgg.py``.

3x3 convolutions with bias (``conv_<i>``, flax's default lecun_normal
init) and ReLU, 2x2 max pools, then ``fc1``, ``fc2`` (ReLU, dropout 0.5 in
train mode) and an fp32 ``head``.  Activations are in ``dtype``, the
4-D tensors channels-last.  The flax model flattens NHWC, so the
classifier here flattens in (h, w, c) order too: ``fc1`` takes the
reference's weight as it is, transposed.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import conv, linear, make_conv, make_dense

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """VGG over NCHW images of ``image_size`` (the classifier's width
    follows it: 224 gives 7 x 7 x 512 inputs to ``fc1``); fp32 logits."""

    def __init__(self, cfg: Sequence = _VGG16_CFG, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 classifier_width: int = 4096, image_size: int = 224):
        super().__init__()
        self.cfg, self.dtype = tuple(cfg), dtype
        cin, hw, i = 3, image_size, 0
        for c in self.cfg:
            if c == "M":
                hw //= 2
            else:
                self.add_module(f"conv_{i}",
                                make_conv(cin, int(c), (3, 3), bias=True))
                cin, i = int(c), i + 1
        self.fc1 = make_dense(cin * hw * hw, classifier_width)
        self.fc2 = make_dense(classifier_width, classifier_width)
        self.head = make_dense(classifier_width, num_classes)
        self.dropout = nn.Dropout(0.5)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        i = 0
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(conv(x, getattr(self, f"conv_{i}"), self.dtype))
                i += 1
        # (h, w, c) order, as the reference flattens NHWC; a free view of a
        # channels-last tensor.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.dropout(F.relu(linear(x, self.fc1, self.dtype)))
        x = self.dropout(F.relu(linear(x, self.fc2, self.dtype)))
        return linear(x.float(), self.head, torch.float32)


VGG16 = functools.partial(VGG, cfg=_VGG16_CFG)
VGG19 = functools.partial(VGG, cfg=_VGG19_CFG)
VGGTiny = functools.partial(VGG, cfg=(8, "M", 16, "M", 32, "M"),
                            classifier_width=64)
