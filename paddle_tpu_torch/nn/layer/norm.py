"""The normalisation layers (counterpart of
``paddle_tpu/nn/layer/norm.py``): LayerNorm, the BatchNorms, GroupNorm,
the InstanceNorms, LocalResponseNorm and SpectralNorm.

``SpectralNorm(weight_shape)`` is the reference's standalone layer:
``forward(weight)`` returns ``weight / sigma``, sigma by
``power_iters`` rounds of power iteration from a ``u`` drawn anew each
call from a generator seeded 0, differentiated through (the
reference's ``static/nn.py`` ``spectral_norm``, whose copy the port
keeps here as ``spectral_norm_weight``).  Its ``u`` is torch's draw
where the reference's is ``jax.random``'s, so the two agree once the
power iteration has converged.
"""
import functools

import torch

from ...core.device import resolve_device
from ...amp import amp_cast
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ['LayerNorm', 'BatchNorm', 'BatchNorm1D', 'BatchNorm2D',
           'BatchNorm3D', 'SyncBatchNorm', 'GroupNorm', 'InstanceNorm1D',
           'InstanceNorm2D', 'InstanceNorm3D', 'LocalResponseNorm',
           'SpectralNorm']


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

    def _group(self):
        """The ranks the batch statistics span: the ``dp`` group inside
        a data-parallel step (``collective.axis_scope``), as under the
        reference's ``dp`` mesh."""
        from ...distributed import collective
        return collective.scope_group('dp')

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats,
            group=self._group() if self.training else None)


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
    """BatchNorm whose training statistics span the ranks: the ``dp``
    group inside a data-parallel step, else the mesh's ``dp`` group,
    else every rank of the process group (one process: its own
    batch)."""

    def _group(self):
        from ...distributed import collective
        from ...distributed import env as _env
        group = collective.scope_group('dp')
        if group is not None:
            return group
        mesh = _env.get_mesh()
        if mesh is not None and mesh.axis_size('dp') > 1:
            return mesh.group('dp')
        world = collective.get_group(0)
        return None if collective._local(world) else world

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Every BatchNorm sublayer of ``layer`` swapped in place for a
        ``SyncBatchNorm`` holding its parameters and statistics."""
        for name, sub in list(layer.named_children()):
            if isinstance(sub, _BatchNormBase) and \
                    not isinstance(sub, SyncBatchNorm):
                new = SyncBatchNorm(sub.num_features, sub.momentum,
                                    sub.epsilon,
                                    data_format=sub.data_format,
                                    device=sub._mean.device)
                with torch.no_grad():
                    for attr in ('weight', 'bias', '_mean', '_variance'):
                        mine, theirs = getattr(new, attr), getattr(sub, attr)
                        if mine is not None and theirs is not None:
                            mine.copy_(theirs)
                setattr(layer, name, new)
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    """``F.group_norm`` with weight (ones) and bias (zeros) of
    ``num_channels``."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=Constant(1.0), device=device)
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, device=device)

    def reset_parameters(self, generator=None):
        del generator
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    """``F.instance_norm`` with weight (ones) and bias (zeros); either
    attr False leaves both None, as in the reference."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCHW',
                 name=None, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0), device=device)
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True,
                device=device)

    reset_parameters = GroupNorm.reset_parameters

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCL',
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format='NCDHW',
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format='NCHW', name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


@functools.lru_cache(maxsize=64)
def _start_u(rows, dtype, device):
    """The power iteration's start: N(0, 1) from a generator seeded 0,
    drawn on the CPU (the same on every device), in ``dtype``."""
    u = torch.randn(rows, generator=torch.Generator().manual_seed(0))
    return u.to(device=device, dtype=dtype)


def spectral_norm_weight(weight, dim=0, power_iters=1, eps=1e-12):
    """``weight / sigma``: the reference's ``static/nn.py``
    ``spectral_norm``.  The matrix is ``weight`` with ``dim`` first and
    the rest flattened; ``max(power_iters, 1)`` rounds of ``v = W^T u /
    (|W^T u| + eps)``, ``u = W v / (|W v| + eps)`` from ``_start_u``;
    ``sigma = u . W v``, all differentiated."""
    weight, = amp_cast('spectral_norm', weight)
    mat = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    u = _start_u(mat.shape[0], mat.dtype, mat.device)
    v = None
    for _ in range(max(int(power_iters), 1)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return weight / (u @ (mat @ v))


class SpectralNorm(Layer):
    """``forward(weight)``: ``spectral_norm_weight`` (the module
    docstring)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps

    def forward(self, weight):
        return spectral_norm_weight(weight, self._dim, self._power_iters,
                                    self._eps)
