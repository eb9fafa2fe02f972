"""Linear and Embedding (counterpart of ``paddle_tpu/nn/layer/common.py``).

Weights keep paddle's layout (``Linear.weight`` is ``[in, out]``) so a
state dict moves between the two packages unchanged.  Parameters are
allocated on the given device; ``reset_parameters(generator)`` draws
the reference's default init (XavierNormal weights, zero bias) from an
explicit CPU ``torch.Generator``, so one seed gives the same weights on
every device.
"""
import math

import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F

__all__ = ['Linear', 'Embedding', 'Dropout', 'xavier_normal_']


def xavier_normal_(param, generator):
    """Fill a 2-D ``[fan_in, fan_out]`` parameter from N(0, 2/(in+out))."""
    fan_in, fan_out = param.shape
    std = math.sqrt(2.0 / (fan_in + fan_out))
    draw = torch.randn(tuple(param.shape), generator=generator,
                       dtype=torch.float32) * std
    with torch.no_grad():
        param.copy_(draw)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in, out]``."""

    def __init__(self, in_features, out_features, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), device=device))
        self.bias = nn.Parameter(torch.empty((out_features,),
                                             device=device))

    def reset_parameters(self, generator):
        xavier_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device))

    def reset_parameters(self, generator):
        xavier_normal_(self.weight, generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """``F.dropout`` with the module's training flag."""

    def __init__(self, p=0.5, axis=None, mode='upscale_in_train'):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
