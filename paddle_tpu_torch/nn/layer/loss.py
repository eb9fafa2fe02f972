"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``; the port
has ``CrossEntropyLoss`` and ``BCEWithLogitsLoss``)."""
from torch import nn

from .. import functional as F

__all__ = ['CrossEntropyLoss', 'BCEWithLogitsLoss']


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


class BCEWithLogitsLoss(nn.Module):
    """``F.binary_cross_entropy_with_logits`` with the layer's
    ``weight``, ``reduction`` and ``pos_weight``."""

    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)
