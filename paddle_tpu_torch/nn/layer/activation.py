"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``;
the port has ``ReLU`` and ``ReLU6``)."""
from torch import nn

from .. import functional as F

__all__ = ['ReLU', 'ReLU6']


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)
