"""ResNet family, 18 to 152 (counterpart of
``paddle_tpu/vision/models/resnet.py``).

The reference's blocks, layer names and state-dict keys (``conv1``,
``bn1``, ``layer1.0.downsample.1._mean``, ...), its ``data_format``
(``'NHWC'`` runs channels-last end to end: each conv and pool takes a
``channels_last`` view, no layout copies) and its space-to-depth stem
(``stem_space_to_depth``: a 4x4/s1 conv over the input's 2x2 blocks,
the same function as the 7x7/s2 stem under
``space_to_depth_stem_weight``).  Ops the reference dispatches by name
(``reshape``, ``transpose``, ``flatten``, the residual ``add``) cast
their inputs through the AMP policy under those names.
``device=None`` is the CUDA card; ``seed`` draws the init from a CPU
generator (``SeededModel``).
"""
import numpy as np
import torch

from ... import nn
from ...amp import amp_cast
from ...core.device import resolve_device
from ...tensor.manipulation import flatten
from ._init import SeededModel

__all__ = ['ResNet', 'BasicBlock', 'BottleneckBlock', 'resnet18',
           'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'space_to_depth_stem_weight']


def _space_to_depth2(x):
    """NHWC block-2 space-to-depth: [B, H, W, C] -> [B, H/2, W/2, 4C]
    with channel order (u, v, c)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(
            f'stem_space_to_depth needs even spatial dims, got {H}x{W}'
            ' — pad or resize the input (the standard stem has no such'
            ' constraint)')
    x, = amp_cast('reshape', x)
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x, = amp_cast('transpose', x)
    x = x.permute(0, 1, 3, 2, 4, 5)
    x, = amp_cast('reshape', x)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def space_to_depth_stem_weight(w7):
    """The exact re-lay of a standard ``[O, 3, 7, 7]`` OIHW stem weight
    into the ``[O, 12, 4, 4]`` weight of the s2d stem (stride 1,
    padding ``((2, 1), (2, 1))``): tap ``di`` of the 7x7/s2/pad-3 conv
    is ``(k, u)`` of the 4x4 conv with ``di = 2k + u - 1`` (the
    ``(k=0, u=0)`` slot lies outside the 7 taps and stays zero).
    numpy in, numpy out."""
    w7 = np.asarray(w7)
    O, C = w7.shape[0], w7.shape[1]
    w2 = np.zeros((O, 4 * C, 4, 4), w7.dtype)
    for k in range(4):
        for u in range(2):
            di = 2 * k + u - 1
            if not 0 <= di < 7:
                continue
            for l in range(4):
                for v in range(2):
                    dj = 2 * l + v - 1
                    if not 0 <= dj < 7:
                        continue
                    for c in range(C):
                        w2[:, (u * 2 + v) * C + c, k, l] = w7[:, c, di, dj]
    return w2


def _conv_bn(in_ch, out_ch, kernel, stride, padding, data_format, device,
             groups=1, dilation=1):
    return (nn.Conv2D(in_ch, out_ch, kernel, stride=stride, padding=padding,
                      groups=groups, dilation=dilation, bias_attr=False,
                      data_format=data_format, device=device),
            nn.BatchNorm2D(out_ch, data_format=data_format, device=device))


def _residual(out, identity):
    out, identity = amp_cast('add', out, identity)
    return out + identity


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format='NCHW', device=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError('BasicBlock only supports groups=1, width=64')
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 3, stride, 1,
                                        data_format, device)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, 1, 1,
                                        data_format, device)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(_residual(out, identity))


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format='NCHW', device=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1, self.bn1 = _conv_bn(inplanes, width, 1, 1, 0,
                                        data_format, device)
        self.conv2, self.bn2 = _conv_bn(width, width, 3, stride, dilation,
                                        data_format, device, groups=groups,
                                        dilation=dilation)
        self.conv3, self.bn3 = _conv_bn(width, planes * self.expansion, 1,
                                        1, 0, data_format, device)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(_residual(out, identity))


class ResNet(SeededModel):
    """ResNet backbone and classifier: ``block`` BasicBlock or
    BottleneckBlock, ``depth`` 18/34/50/101/152, ``num_classes <= 0``
    drops the head, ``with_pool`` the global average pool before it,
    ``data_format`` ``'NCHW'`` or ``'NHWC'``."""

    _layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth, num_classes=1000, with_pool=True,
                 data_format='NCHW', stem_space_to_depth=False,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        layers = self._layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        self.stem_space_to_depth = stem_space_to_depth
        self.inplanes = 64
        if stem_space_to_depth:
            if data_format != 'NHWC':
                raise ValueError('stem_space_to_depth is the TPU-layout '
                                 'stem; use data_format="NHWC"')
            self.conv1 = nn.Conv2D(12, 64, 4, stride=1,
                                   padding=[(2, 1), (2, 1)],
                                   bias_attr=False, data_format=data_format,
                                   device=device)
        else:
            self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                                   bias_attr=False, data_format=data_format,
                                   device=device)
        self.bn1 = nn.BatchNorm2D(64, data_format=data_format, device=device)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, device)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, device)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, device)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, device)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=device)
        self.init_weights(seed)

    def _make_layer(self, block, planes, n_blocks, stride, device):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            conv, bn = _conv_bn(self.inplanes, planes * block.expansion, 1,
                                stride, 0, self.data_format, device)
            downsample = nn.Sequential(conv, bn)
        blocks = [block(self.inplanes, planes, stride, downsample,
                        data_format=self.data_format, device=device)]
        self.inplanes = planes * block.expansion
        for _ in range(1, n_blocks):
            blocks.append(block(self.inplanes, planes,
                                data_format=self.data_format,
                                device=device))
        return nn.Sequential(*blocks)

    def forward(self, x):
        if self.stem_space_to_depth:
            x = _space_to_depth2(x)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            'pretrained weights are unavailable in this zero-egress build; '
            'load a checkpoint with load_numpy_state')
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
