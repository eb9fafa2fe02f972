"""Linear and Embedding (counterpart of ``paddle_tpu/nn/layer/common.py``).

Weights keep paddle's layout (``Linear.weight`` is ``[in, out]``) so a
state dict moves between the two packages unchanged.  Parameters are
allocated on the given device; ``reset_parameters(generator)`` draws
the reference's default init (``Linear``: XavierNormal weights, zero
bias; ``Embedding``: N(0, 1)) from an explicit CPU ``torch.Generator``,
so one seed gives the same weights on every device.
"""
import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import Normal, XavierNormal

__all__ = ['Linear', 'Embedding', 'Dropout']


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
        XavierNormal().fill_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``, drawn
    from N(0, 1) as the reference's ``nn.Embedding`` draws it."""

    def __init__(self, num_embeddings, embedding_dim, device=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device))

    def reset_parameters(self, generator):
        Normal(0.0, 1.0).fill_(self.weight, generator)

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
