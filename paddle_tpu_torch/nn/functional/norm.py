"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``layer_norm``, ``batch_norm``,
``instance_norm``, ``group_norm`` and ``local_response_norm``, each
with the reference's arithmetic and dtypes.

The statistics accumulate in f32: the variance is two-pass for an f32
input and one-pass for a 16-bit one (``_one_pass_var``).  The dtypes
follow the reference's formulas, not PyTorch's ops: ``group_norm``
normalises in x's dtype and then multiplies by the weight in the
weight's, so a bf16 ``x`` with f32 weight and bias comes back f32;
``instance_norm`` folds weight and bias into an f32 scale and shift
cast to x's dtype, so it comes back in x's.  ``local_response_norm``
divides by ``(k + alpha * sum(x^2))^beta`` over a channel window padded
``(size // 2, size - size // 2 - 1)``, with ``alpha`` not divided by
``size`` (PyTorch's divides it).  ``group_norm`` runs inside a
``group_norm`` ``record_function`` range, as ``batch_norm`` does, so a
profile of a step can attribute its kernels.
"""
import math

import torch
import torch.nn.functional as TF
from torch.profiler import record_function

from ...amp import amp_cast
from ...core.recompute import recomputing
from ...ops.fused_norm import fused_layer_norm
from .conv import CHANNEL_LAST

__all__ = ['batch_norm', 'layer_norm', 'instance_norm', 'group_norm',
           'local_response_norm']


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape``.  Over the last
    axis alone it runs ``fused_layer_norm`` (the kernel on a CUDA
    tensor, with or without weight/bias); over more axes the
    reference's plain path: f32 statistics, ``1 / sqrt(var + eps)``
    rounded to x's dtype, ``(x - mean) * inv`` then the weight and bias
    in x's dtype.  It is on the AMP keep list: a bf16 ``x`` keeps f32
    gamma/beta and f32 statistics."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast('layer_norm', x, weight, bias)
    n_axes = len(tuple(normalized_shape))
    if n_axes == 1:
        return fused_layer_norm(x, weight, bias, eps=epsilon)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    mean, var = _stats(x, axes)
    inv = (1.0 / torch.sqrt(var + epsilon)).to(x.dtype)
    out = (x - mean.to(x.dtype)) * inv
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _one_pass_var(v, axes, mean, keepdim=False):
    """E[x^2] - E[x]^2 with an f32 mean of the squares, clamped at 0.
    A bf16 ``v`` is squared in bf16 (the reference keeps the square in
    bf16 so its autodiff saves no f32 copy); other dtypes upcast
    first."""
    sq = v.square() if v.dtype == torch.bfloat16 else v.float().square()
    var = sq.mean(dim=axes, dtype=torch.float32, keepdim=keepdim) \
        - mean.square()
    return torch.clamp_min(var, 0.0)


def _stats(v, axes):
    """(mean, variance) over ``axes``, kept as size-1 dims, in f32: the
    two-pass variance for an f32 ``v``, ``_one_pass_var`` otherwise."""
    mean = v.mean(dim=axes, dtype=torch.float32, keepdim=True)
    if v.dtype == torch.float32:
        return mean, v.var(dim=axes, correction=0, keepdim=True)
    return mean, _one_pass_var(v, axes, mean, keepdim=True)


def _scalar(value, dtype):
    """A Python scalar as the reference's weakly typed constant meets a
    ``dtype`` tensor: rounded to ``dtype`` first (PyTorch would multiply
    a 16-bit tensor by the f32 value)."""
    if dtype in (torch.float32, torch.float64):
        return value
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _multiply(t, value):
    """The reference's ``Tensor * python scalar`` (op ``multiply``)."""
    t, = amp_cast('multiply', t)
    return t * _scalar(value, t.dtype)


@torch.no_grad()
def _update_running(running, batch_stat, momentum):
    """``running <- running * momentum + batch * (1 - momentum)`` as the
    reference's Tensor ops compute it (each cast by the AMP policy: bf16
    under O2), written back in ``running``'s dtype in place, so a
    captured graph keeps the buffer's address.  A recomputation
    (``core.recompute``) writes nothing: the forward moved them once."""
    if recomputing():
        return
    a = _multiply(running, momentum)
    b = _multiply(batch_stat, 1.0 - momentum)
    a, b = amp_cast('add', a, b)
    running.copy_(a + b)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format='NCHW', use_global_stats=None, name=None):
    """BatchNorm over every axis but the channel's, the reference's
    arithmetic.

    With batch statistics (``training`` and not ``use_global_stats``):
    the mean accumulates in f32; the variance is two-pass for f32 input
    and one-pass for 16-bit input (``_one_pass_var``); ``scale = w /
    sqrt(var + eps)`` and ``shift = b - mean * scale`` are formed in f32
    and cast to the input's dtype, and the output is ``x * scale +
    shift`` in that dtype.  Gradients flow through the statistics.  The
    running statistics then move by paddle's ``momentum`` (``running *
    0.9 + batch * 0.1``), the variance unbiased by ``n / (n - 1)``, in
    place (``_update_running``).  Otherwise the running statistics,
    taken to f32, normalise.  On the AMP keep list: the inputs come as
    they are.  Not ``F.batch_norm``: cuDNN's statistics are other
    arithmetic in another order."""
    channel_last = data_format in CHANNEL_LAST
    ch = x.dim() - 1 if channel_last else min(1, x.dim() - 1)
    red = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    f32 = torch.float32
    with record_function('batch_norm'):
        if training and not use_global_stats:
            x, weight, bias = amp_cast('batch_norm', x, weight, bias)
            mean = x.mean(dim=red, dtype=f32)
            if x.dtype == f32:
                var = x.var(dim=red, correction=0)
            else:
                var = _one_pass_var(x, red, mean)
            scale = 1.0 / torch.sqrt(var + epsilon)
            if weight is not None:
                scale = scale * weight.float()
            shift = -mean * scale
            if bias is not None:
                shift = shift + bias.float()
            out = (x * scale.reshape(shape).to(x.dtype)
                   + shift.reshape(shape).to(x.dtype))
            n = math.prod(x.shape[i] for i in red)
            if running_mean is not None:
                _update_running(running_mean, mean.detach(), momentum)
            if running_var is not None:
                _update_running(running_var,
                                _multiply(var.detach(), n / max(n - 1, 1)),
                                momentum)
            return out
        x, rm, rv, weight, bias = amp_cast('batch_norm', x, running_mean,
                                           running_var, weight, bias)
        scale = 1.0 / torch.sqrt(rv.float() + epsilon)
        if weight is not None:
            scale = scale * weight.float()
        shift = -rm.float() * scale
        if bias is not None:
            shift = shift + bias.float()
        return (x * scale.reshape(shape).to(x.dtype)
                + shift.reshape(shape).to(x.dtype))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format='NCHW', name=None):
    """Normalisation of each (sample, channel) over its spatial axes;
    weight and bias fold into an f32 scale and shift, applied in x's
    dtype.  The running statistics, ``use_input_stats`` and
    ``momentum`` are taken and not read, as in the reference."""
    channel_last = data_format in CHANNEL_LAST
    x, weight, bias = amp_cast('instance_norm', x, weight, bias)
    ch = x.dim() - 1 if channel_last else 1
    red = tuple(range(1, x.dim() - 1)) if channel_last else \
        tuple(range(2, x.dim()))
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    mean, var = _stats(x, red)
    scale = 1.0 / torch.sqrt(var + eps)
    shift = -mean * scale
    if weight is not None:
        w = weight.reshape(shape).float()
        scale, shift = scale * w, shift * w
    if bias is not None:
        shift = shift + bias.reshape(shape).float()
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format='NCHW', name=None):
    """Normalisation over each group of ``C / num_groups`` channels and
    the spatial axes: f32 statistics, ``(x - mean) * inv`` in x's dtype,
    then ``* weight + bias`` in the promoted dtype (f32 for a bf16 ``x``
    with f32 parameters, as in the reference)."""
    channel_last = data_format in CHANNEL_LAST
    x, weight, bias = amp_cast('group_norm', x, weight, bias)
    with record_function('group_norm'):
        v = x.movedim(-1, 1) if channel_last else x
        n, c = v.shape[0], v.shape[1]
        grouped = v.reshape((n, num_groups, c // num_groups)
                            + tuple(v.shape[2:]))
        mean, var = _stats(grouped, tuple(range(2, grouped.dim())))
        inv = 1.0 / torch.sqrt(var + epsilon)
        out = ((grouped - mean.to(grouped.dtype)) * inv.to(grouped.dtype)
               ).reshape(v.shape)
        shape = [1] * v.dim()
        shape[1] = c
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format='NCHW', name=None):
    """``x / (k + alpha * s)^beta``, ``s`` the sum of squares over a
    window of ``size`` channels padded ``(size // 2, size - size // 2 -
    1)``; ``alpha`` is not divided by ``size`` (the reference's
    formula), and the constants meet a 16-bit ``x`` rounded to its
    dtype, as the reference's weakly typed ones do."""
    x, = amp_cast('local_response_norm', x)
    ch = x.dim() - 1 if data_format in CHANNEL_LAST else 1
    half = size // 2
    sq = x.square()
    pads = [0, 0] * (x.dim() - 1 - ch) + [half, size - half - 1]
    padded = TF.pad(sq, pads)
    acc = sum(padded.narrow(ch, i, x.shape[ch]) for i in range(size))
    dt = x.dtype
    base = _scalar(k, dt) + _scalar(alpha, dt) * acc
    return x / base.pow(_scalar(beta, dt))
