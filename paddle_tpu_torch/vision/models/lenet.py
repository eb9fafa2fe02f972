"""LeNet for MNIST-shaped inputs (counterpart of
``paddle_tpu/vision/models/lenet.py``): the reference's layers and
state-dict keys, NCHW input ``[B, 1, 28, 28]``."""
from ... import nn
from ...core.device import resolve_device
from ...tensor.manipulation import flatten
from ._init import SeededModel

__all__ = ['LeNet']


class LeNet(SeededModel):
    """LeNet-5 style conv net; ``num_classes <= 0`` drops the head and
    returns the features.  ``device=None`` is the CUDA card; ``seed``
    draws the init (``SeededModel``)."""

    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1, device=device),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0, device=device),
            nn.ReLU(),
            nn.MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, device=device),
                nn.Linear(120, 84, device=device),
                nn.Linear(84, num_classes, device=device))
        self.init_weights(seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
