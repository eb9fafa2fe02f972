"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; the port has ``layer_norm`` and
``batch_norm``)."""
import math

import torch
from torch.profiler import record_function

from ...amp import amp_cast
from ...ops.fused_norm import fused_layer_norm
from .conv import CHANNEL_LAST

__all__ = ['layer_norm', 'batch_norm']


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the last axis, through ``fused_layer_norm`` (the
    kernel on a CUDA tensor, with or without weight/bias).  It is on
    the AMP keep list: a bf16 ``x`` keeps f32 gamma/beta and f32
    statistics.  The reference's multi-axis plain path has no caller in
    the port yet."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if len(tuple(normalized_shape)) != 1:
        raise NotImplementedError(
            'layer_norm over more than one axis is not ported yet')
    x, weight, bias = amp_cast('layer_norm', x, weight, bias)
    return fused_layer_norm(x, weight, bias, eps=epsilon)


def _one_pass_var(v, axes, mean):
    """E[x^2] - E[x]^2 with an f32 mean of the squares, clamped at 0.
    A bf16 ``v`` is squared in bf16 (the reference keeps the square in
    bf16 so its autodiff saves no f32 copy); other dtypes upcast
    first."""
    sq = v.square() if v.dtype == torch.bfloat16 else v.float().square()
    var = sq.mean(dim=axes, dtype=torch.float32) - mean.square()
    return torch.clamp_min(var, 0.0)


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
    captured graph keeps the buffer's address."""
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
