"""MobileNetV2, inverted residuals with linear bottlenecks (counterpart
of ``paddle_tpu/vision/models/mobilenetv2.py``): the reference's blocks,
``scale`` (channels rounded by ``_make_divisible``) and state-dict keys,
NCHW.  The residual add casts through the AMP policy as the reference's
``add``.  ``device=None`` is the CUDA card; ``seed`` draws the init from
a CPU generator (``SeededModel``).
"""
import torch

from ... import nn
from ...core.device import resolve_device
from ...tensor.manipulation import flatten
from ...tensor.math import add
from ._init import SeededModel

__all__ = ['MobileNetV2', 'mobilenet_v2', 'InvertedResidual']


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBNReLU6(torch.nn.Module):
    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1,
                 device=None):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = nn.Conv2D(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, groups=groups, bias_attr=False,
                              device=device)
        self.bn = nn.BatchNorm2D(out_ch, device=device)
        self.act = nn.ReLU6()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class InvertedResidual(torch.nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU6(inp, hidden, kernel=1, device=device))
        layers.append(_ConvBNReLU6(hidden, hidden, stride=stride,
                                   groups=hidden, device=device))
        layers.append(nn.Conv2D(hidden, oup, 1, bias_attr=False,
                                device=device))
        layers.append(nn.BatchNorm2D(oup, device=device))
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return add(x, out) if self.use_res else out


# (expand_ratio t, out-channels c, repeats n, stride s)
_CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(SeededModel):
    """A 3x3/s2 stem, 17 inverted residual blocks and a 1x1 conv to
    1280 channels at width ``scale``, a global average pool
    (``with_pool``) and a dropout-0.2 ``num_classes`` head (none when
    ``num_classes <= 0``)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_ch = _make_divisible(32 * scale)
        last_ch = _make_divisible(1280 * max(1.0, scale))
        blocks = [_ConvBNReLU6(3, in_ch, stride=2, device=device)]
        for t, c, n, s in _CFG:
            out_ch = _make_divisible(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(
                    in_ch, out_ch, s if i == 0 else 1, t, device=device))
                in_ch = out_ch
        blocks.append(_ConvBNReLU6(in_ch, last_ch, kernel=1, device=device))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes,
                                           device=device))
        self.init_weights(seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            'pretrained weights are unavailable in this zero-egress build; '
            'load a checkpoint with load_numpy_state')
    return MobileNetV2(scale=scale, **kwargs)
