"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``; the port
has ``CrossEntropyLoss``)."""
from torch import nn

from .. import functional as F

__all__ = ['CrossEntropyLoss']


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with the layer's settings; integer labels
    ``[B]`` or ``[B, 1]``."""

    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax)
