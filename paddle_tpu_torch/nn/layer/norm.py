"""LayerNorm and BatchNorm (counterpart of
``paddle_tpu/nn/layer/norm.py``)."""
import torch

from ...core.device import resolve_device
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ['LayerNorm', 'BatchNorm', 'BatchNorm1D', 'BatchNorm2D',
           'BatchNorm3D', 'SyncBatchNorm']


class LayerNorm(Layer):
    """LayerNorm with weight (ones) and bias (zeros) over the trailing
    ``normalized_shape``; runs ``F.layer_norm``, hence the kernel.  The
    reference's signature, ``device`` keyword-only; ``weight_attr`` or
    ``bias_attr`` False leaves that parameter None and out of the state
    dict."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0), device=device)
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def reset_parameters(self, generator=None):
        del generator
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class _BatchNormBase(Layer):
    """BatchNorm with weight (ones), bias (zeros) and the running
    statistics as f32 buffers under the reference's names, ``_mean``
    (zeros) and ``_variance`` (ones), so a state dict carries keys such
    as ``bn1._mean``.  Training updates the buffers in place
    (``F.batch_norm``), which a captured CUDA graph needs."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)
        self.register_buffer('_mean', torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer('_variance', torch.ones(
            num_features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator=None):
        del generator
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)


class BatchNorm(_BatchNormBase):
    """The layout-agnostic alias (the reference's
    ``fluid.dygraph.BatchNorm``)."""


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 use_global_stats=None, name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 use_global_stats=None, name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica statistics wait for the distributed slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'SyncBatchNorm waits for the distributed slice (ROADMAP Queue '
            '1 item 9)')
