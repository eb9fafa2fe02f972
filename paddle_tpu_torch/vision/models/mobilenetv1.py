"""MobileNetV1, depthwise-separable convolutions (counterpart of
``paddle_tpu/vision/models/mobilenetv1.py``): the reference's blocks,
``scale`` and state-dict keys, NCHW.  A depthwise convolution is a
``Conv2D`` with ``groups`` equal to its channels (cuDNN's grouped
convolution).  ``device=None`` is the CUDA card; ``seed`` draws the init
from a CPU generator (``SeededModel``).
"""
import torch

from ... import nn
from ...core.device import resolve_device
from ...tensor.manipulation import flatten
from ._init import SeededModel

__all__ = ['MobileNetV1', 'mobilenet_v1']


class _ConvBNReLU(torch.nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 groups=1, device=None):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, device=device)
        self.bn = nn.BatchNorm2D(out_ch, device=device)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _DepthwiseSeparable(torch.nn.Module):
    def __init__(self, in_ch, mid_ch, out_ch, stride, scale, device=None):
        super().__init__()
        mid = int(mid_ch * scale)
        self.depthwise = _ConvBNReLU(int(in_ch * scale), mid, 3,
                                     stride=stride, padding=1, groups=mid,
                                     device=device)
        self.pointwise = _ConvBNReLU(mid, int(out_ch * scale), 1,
                                     device=device)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


# (in, mid, out, stride) per depthwise-separable stage
_STAGES = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
           (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
           (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
           (1024, 1024, 1024, 1)]


class MobileNetV1(SeededModel):
    """A 3x3/s2 stem and 13 depthwise-separable stages at width
    ``scale``, a global average pool (``with_pool``) and a
    ``num_classes`` head (none when ``num_classes <= 0``)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        blocks = [_ConvBNReLU(3, int(32 * scale), 3, stride=2, padding=1,
                              device=device)]
        for in_ch, mid_ch, out_ch, stride in _STAGES:
            blocks.append(_DepthwiseSeparable(in_ch, mid_ch, out_ch, stride,
                                              scale, device=device))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes,
                                device=device)
        self.init_weights(seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            'pretrained weights are unavailable in this zero-egress build; '
            'load a checkpoint with load_numpy_state')
    return MobileNetV1(scale=scale, **kwargs)
