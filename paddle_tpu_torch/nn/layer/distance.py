"""Distance layers (counterpart of
``paddle_tpu/nn/layer/distance.py``)."""
from ...amp import amp_cast
from .layers import Layer

__all__ = ['PairwiseDistance']


class PairwiseDistance(Layer):
    """``sum(|x - y + epsilon|^p) ^ (1/p)`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        a, b = amp_cast('pairwise_distance', x, y)
        d = a - b + self.epsilon
        return (d.abs() ** self.p).sum(dim=-1, keepdim=self.keepdim) \
            ** (1.0 / self.p)
