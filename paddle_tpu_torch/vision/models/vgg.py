"""The VGG family, 11/13/16/19 with optional BatchNorm (counterpart of
``paddle_tpu/vision/models/vgg.py``): the reference's layers,
``make_layers`` configurations and state-dict keys (``features.0.weight``,
``classifier.6.bias``, ...), NCHW.  ``device=None`` is the CUDA card;
``seed`` draws the init from a CPU generator (``SeededModel``).
"""
from ... import nn
from ...core.device import resolve_device
from ...tensor.manipulation import flatten
from ._init import SeededModel

__all__ = ['VGG', 'vgg11', 'vgg13', 'vgg16', 'vgg19', 'make_layers']

# number = out-channels of a 3x3 conv, 'M' = 2x2 max-pool
_CFGS = {
    'A': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'B': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M',
          512, 512, 'M'],
    'D': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512,
          'M', 512, 512, 512, 'M'],
    'E': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
          512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'],
}


def make_layers(cfg, batch_norm=False, device=None):
    """The conv tower of ``cfg`` (a list of widths and ``'M'``)."""
    device = resolve_device(device)
    layers = []
    in_ch = 3
    for v in cfg:
        if v == 'M':
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_ch, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v, device=device))
            layers.append(nn.ReLU())
            in_ch = v
    return nn.Sequential(*layers)


class VGG(SeededModel):
    """``features`` (``make_layers``), a 7 x 7 adaptive average pool
    (``with_pool``) and the 25088-4096-4096-``num_classes`` classifier
    with dropout 0.5 (none when ``num_classes <= 0``)."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, device=device),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, device=device),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes, device=device))
        self.init_weights(seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, **kwargs):
    if pretrained:
        raise NotImplementedError(
            'pretrained weights are unavailable in this zero-egress build; '
            'load a checkpoint with load_numpy_state')
    return VGG(make_layers(_CFGS[cfg], batch_norm=batch_norm, device=device),
               device=device, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('A', batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('B', batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('D', batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('E', batch_norm, pretrained, **kwargs)
