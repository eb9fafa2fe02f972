"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Embedding``, the dropouts, ``Flatten``, the pads,
``Identity``, ``CosineSimilarity``, ``Upsample`` and its nearest and
bilinear forms, ``Bilinear`` and ``Unfold``.

The signatures are the reference's, positional arguments included
(``Linear(in, out, weight_attr, bias_attr, name)``,
``Embedding(num, dim, padding_idx, sparse, weight_attr, name)``);
``device`` is keyword-only.  Weights keep paddle's layout
(``Linear.weight`` is ``[in, out]``) so a state dict moves between the
two packages unchanged.  Parameters are drawn at construction
(``Layer.create_parameter``: the attr's initializer, else the
reference's default, ``Linear`` XavierNormal weights and zero bias,
``Embedding`` N(0, 1)); ``bias_attr=False`` leaves ``bias`` None and out
of the state dict.  The models that seed their own init call
``reset_parameters(generator)``, which redraws the default laws from
an explicit CPU ``torch.Generator``, so one seed gives the same weights
on every device.  ``Embedding``'s ``padding_idx`` row is zeroed at
construction and its lookups are masked (``F.embedding``), so that row
gets no gradient.
"""
import math

import torch

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import Normal, Uniform, XavierNormal
from .layers import Layer

__all__ = ['Linear', 'Embedding', 'Dropout', 'Dropout2D', 'Dropout3D',
           'AlphaDropout', 'Flatten', 'Pad1D', 'Pad2D', 'Pad3D',
           'CosineSimilarity', 'Identity', 'Upsample', 'UpsamplingNearest2D',
           'UpsamplingBilinear2D', 'Bilinear', 'Unfold']


class Linear(Layer):
    """``y = x @ weight + bias`` with ``weight [in, out]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal(), device=device)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=device)

    def reset_parameters(self, generator):
        XavierNormal().fill_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f'in={self.in_features}, out={self.out_features}'


class Embedding(Layer):
    """Row lookup into ``weight [num_embeddings, embedding_dim]``, drawn
    from N(0, 1) as the reference's ``nn.Embedding`` draws it."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0), device=device)
        self._zero_padding_row()

    def _zero_padding_row(self):
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def reset_parameters(self, generator):
        Normal(0.0, 1.0).fill_(self.weight, generator)
        self._zero_padding_row()

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx, self.sparse)


class Dropout(Layer):
    """``F.dropout`` with the module's training flag."""

    def __init__(self, p=0.5, axis=None, mode='upscale_in_train', name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format='NCHW', name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format='NCDHW', name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class _PadND(Layer):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCHW', name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCL', name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    def __init__(self, padding, mode='constant', value=0.0,
                 data_format='NCDHW', name=None):
        super().__init__(padding, mode, value, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    """``F.interpolate`` with the layer's size or scale and mode."""

    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=False, align_mode=0, data_format='NCHW',
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'nearest',
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format='NCHW',
                 name=None):
        super().__init__(size, scale_factor, 'bilinear', True,
                         data_format=data_format)


class Bilinear(Layer):
    """``F.bilinear`` with ``weight [out, in1, in2]`` and bias, both
    ``Uniform(+-1/sqrt(in1))`` by default."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        bound = 1.0 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=Uniform(-bound, bound), device=device)
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), device=device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)
