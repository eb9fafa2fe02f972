"""LayerNorm and BatchNorm (counterpart of
``paddle_tpu/nn/layer/norm.py``)."""
import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F

__all__ = ['LayerNorm', 'BatchNorm', 'BatchNorm1D', 'BatchNorm2D',
           'BatchNorm3D', 'SyncBatchNorm']


class LayerNorm(nn.Module):
    """LayerNorm with weight (ones) and bias (zeros) over the trailing
    ``normalized_shape``; runs ``F.layer_norm``, hence the kernel."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device))

    def reset_parameters(self, generator=None):
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class _BatchNormBase(nn.Module):
    """BatchNorm with weight (ones), bias (zeros) and the running
    statistics as f32 buffers under the reference's names, ``_mean``
    (zeros) and ``_variance`` (ones), so a state dict carries keys such
    as ``bn1._mean``.  Training updates the buffers in place
    (``F.batch_norm``), which a captured CUDA graph needs."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        if weight_attr is not None or bias_attr is not None:
            raise NotImplementedError('ParamAttr is not ported')
        device = resolve_device(device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer('_mean', torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer('_variance', torch.ones(
            num_features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator=None):
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
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
