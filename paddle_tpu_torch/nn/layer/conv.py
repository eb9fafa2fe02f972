"""Conv layers (counterpart of ``paddle_tpu/nn/layer/conv.py``).

The weight is ``[out, in/groups, *k]`` (OIHW) whatever ``data_format``
is, as in the reference, so state dicts move unchanged; the transposed
layers' is the reference's ``[in, out/groups, *k]``.  Parameters are
drawn at construction (``Layer.create_parameter``): the attr's
initializer, else the reference's defaults, ``KaimingUniform(fan_in)``
weights and ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))`` bias, with
``fan_in = in/groups * prod(k)`` for either kind; ``bias_attr=False``
leaves ``bias`` None.  The models that seed their own init call
``reset_parameters(generator)``, which redraws the default laws from an
explicit CPU generator.  ``padding_mode`` is taken and, as in the
reference, never read: the convolutions pad with zeros.
"""
import math

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = ['Conv1D', 'Conv2D', 'Conv3D', 'Conv1DTranspose',
           'Conv2DTranspose', 'Conv3DTranspose']


class _ConvNd(Layer):
    _n = None
    _fn = None
    _transposed = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode='zeros',
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 device=None):
        super().__init__()
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
        self.padding_mode = padding_mode
        self._fan_in = in_channels // groups * math.prod(self.kernel_size)
        shape = [in_channels, out_channels // groups] if self._transposed \
            else [out_channels, in_channels // groups]
        bound = 1.0 / math.sqrt(self._fan_in)
        self.weight = self.create_parameter(
            shape + self.kernel_size, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=self._fan_in),
            device=device)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), device=device)

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


class _ConvNdTranspose(_ConvNd):
    _transposed = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, 'zeros', weight_attr,
                         bias_attr, data_format, device)
        self.output_padding = output_padding

    def forward(self, x, output_size=None):
        return self._fn(x, self.weight, self.bias, self.stride,
                        self.padding, self.output_padding, self.groups,
                        self.dilation, output_size, self.data_format)


class Conv1DTranspose(_ConvNdTranspose):
    _n, _fn = 1, staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device)


class Conv2DTranspose(_ConvNdTranspose):
    _n, _fn = 2, staticmethod(F.conv2d_transpose)


class Conv3DTranspose(_ConvNdTranspose):
    _n, _fn = 3, staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device)
