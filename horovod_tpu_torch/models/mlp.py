"""MNIST-scale MLP: port of ``horovod_tpu/models/mlp.py``.

Dense layers ``dense_<i>`` with ReLU in ``dtype``, then an fp32 ``head``;
the input is flattened per example.  flax infers the input width at init,
so the port takes it as ``in_features`` (784 for 28x28x1 images).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import linear, make_dense


class MLP(nn.Module):
    def __init__(self, in_features: int = 784,
                 features: Sequence[int] = (512, 256, 10),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = [in_features, *features]
        for i in range(len(features) - 1):
            self.add_module(f"dense_{i}", make_dense(widths[i], widths[i + 1]))
        self.head = make_dense(widths[-2], widths[-1])
        self.hidden = len(features) - 1

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.hidden):
            x = F.relu(linear(x, getattr(self, f"dense_{i}"), self.dtype))
        return linear(x.float(), self.head, torch.float32)


def xent_loss(logits, labels):
    """Mean cross entropy of integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()
