"""Conv layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

The weight is ``[out, in/groups, *k]`` (OIHW) whatever ``data_format``
is, as in the reference, so state dicts move unchanged.  The default
init is the reference's: ``KaimingUniform(fan_in)`` weights and
``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))`` bias, drawn by
``reset_parameters(generator)`` from an explicit CPU generator;
``bias_attr=False`` leaves ``bias`` None.  The transposed layers are
not ported yet.
"""
import math

import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import KaimingUniform, Uniform

__all__ = ['Conv1D', 'Conv2D', 'Conv3D']


class _ConvNd(nn.Module):
    _n = None
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 device=None):
        super().__init__()
        if padding_mode != 'zeros':
            raise NotImplementedError(
                f"padding_mode {padding_mode!r}: only 'zeros' is ported")
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError(
                'ParamAttr initializers are not ported; use '
                'bias_attr=False or the default init')
        device = resolve_device(device)
        n = self._n
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) else \
            [kernel_size] * n
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = [int(k) for k in ks]
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._fan_in = in_channels // groups * math.prod(self.kernel_size)
        self.weight = nn.Parameter(torch.empty(
            [out_channels, in_channels // groups] + self.kernel_size,
            device=device))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.empty((out_channels,), device=device))

    def reset_parameters(self, generator):
        KaimingUniform(fan_in=self._fan_in).fill_(self.weight, generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self._fan_in)
            Uniform(-bound, bound).fill_(self.bias, generator)

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'kernel_size={self.kernel_size}, stride={self.stride}')


class Conv1D(_ConvNd):
    _n, _fn = 1, staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device)


class Conv2D(_ConvNd):
    _n, _fn = 2, staticmethod(F.conv2d)


class Conv3D(_ConvNd):
    _n, _fn = 3, staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device)
