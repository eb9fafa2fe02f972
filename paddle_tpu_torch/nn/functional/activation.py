"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``): all 29 of the reference's,
with its in-place ``relu_``, ``elu_`` and ``softmax_``.  Each casts its
input through the AMP policy under the reference's op name
(``softplus`` and ``log_softmax`` are black-listed: f32), and each
computes the reference's formula, so the gradient splits where its
``jnp.where`` splits (``leaky_relu`` takes the slope-1 side at 0)."""
import torch
import torch.nn.functional as TF

from ...amp import amp_cast
from ...core import rng
from ...core.dtype import convert_dtype
from ...ops.fused_softmax import fused_softmax

__all__ = [
    'relu', 'relu6', 'relu_', 'gelu', 'sigmoid', 'softmax', 'log_softmax',
    'tanh', 'leaky_relu', 'elu', 'selu', 'celu', 'hardswish', 'hardsigmoid',
    'swish', 'silu', 'mish', 'softplus', 'softsign', 'hardtanh',
    'hardshrink', 'softshrink', 'tanhshrink', 'prelu', 'glu', 'maxout',
    'thresholded_relu', 'log_sigmoid', 'gumbel_softmax', 'elu_', 'softmax_',
]


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def relu(x, name=None):
    x, = amp_cast('relu', x)
    return torch.relu(x)


def relu_(x, name=None):
    """``relu`` written into ``x``."""
    return torch.relu_(x)


def relu6(x, name=None):
    """``min(max(x, 0), 6)``; its gradient is 0 at 0 and at 6, as
    ``jax.nn.relu6``'s."""
    x, = amp_cast('relu6', x)
    return TF.relu6(x)


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` that the
    reference's ``mlp_gelu`` uses."""
    x, = amp_cast('gelu', x)
    return TF.gelu(x, approximate='tanh' if approximate else 'none')


def sigmoid(x, name=None):
    x, = amp_cast('sigmoid', x)
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    x, = amp_cast('log_sigmoid', x)
    return TF.logsigmoid(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax along ``axis``: the last axis goes through
    ``fused_softmax`` (the hand-written kernel on a CUDA tensor), any
    other through ``torch.softmax``, as in the reference.  ``softmax``
    is black-listed under AMP, so the kernel sees f32 scores; ``dtype``
    (a torch dtype, a name or a numpy dtype) casts the input first, so
    the result takes it, where the reference reads no ``dtype`` and
    keeps x's."""
    x, = amp_cast('softmax', x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    if axis in (-1, x.dim() - 1):
        return fused_softmax(x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast('log_softmax', x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def tanh(x, name=None):
    x, = amp_cast('tanh', x)
    return torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    """``x`` where ``x >= 0``, ``negative_slope * x`` elsewhere."""
    x, = amp_cast('leaky_relu', x)
    return torch.where(x >= 0, x, x * negative_slope)


def elu(x, alpha=1.0, name=None):
    x, = amp_cast('elu', x)
    neg = torch.where(x > 0, _zero(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(neg))


def elu_(x, alpha=1.0, name=None):
    """``elu`` written into ``x``."""
    return TF.elu_(x, alpha)


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    x, = amp_cast('selu', x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x, = amp_cast('celu', x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def hardswish(x, name=None):
    """``x * relu6(x + 3) / 6`` (``jax.nn.hard_swish``)."""
    x, = amp_cast('hardswish', x)
    return x * TF.relu6(x + 3.0) / 6.0


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    x, = amp_cast('hardsigmoid', x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def swish(x, name=None):
    x, = amp_cast('swish', x)
    return TF.silu(x)


silu = swish


def mish(x, name=None):
    x, = amp_cast('mish', x)
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log(1 + exp(beta *
    x)) / beta``."""
    x, = amp_cast('softplus', x)
    bx = beta * x
    return torch.where(bx > threshold, x,
                       (1.0 / beta) * torch.logaddexp(bx, _zero(bx)))


def softsign(x, name=None):
    x, = amp_cast('softsign', x)
    return x / (x.abs() + 1)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = amp_cast('hardtanh', x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    x, = amp_cast('hardshrink', x)
    return torch.where(x.abs() > threshold, x, _zero(x))


def softshrink(x, threshold=0.5, name=None):
    x, = amp_cast('softshrink', x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x, name=None):
    x, = amp_cast('tanhshrink', x)
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    x, = amp_cast('thresholded_relu', x)
    return torch.where(x > threshold, x, _zero(x))


def prelu(x, weight, data_format='NCHW', name=None):
    """``x`` where ``x >= 0``, ``weight * x`` elsewhere: one weight, or
    one per channel (axis 1, or the last for a channel-last
    ``data_format``)."""
    x, weight = amp_cast('prelu', x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format == 'NCHW' else x.dim() - 1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def glu(x, axis=-1, name=None):
    x, = amp_cast('glu', x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` consecutive channels of
    ``axis``."""
    x, = amp_cast('maxout', x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g`` from
    the device's generator; ``hard`` gives the one-hot of the argmax
    with the soft sample's gradient."""
    x, = amp_cast('gumbel_softmax', x)
    u = torch.rand(x.shape, generator=rng.generator(x.device),
                   device=x.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp_min(tiny)))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def softmax_(x, axis=-1, dtype=None, name=None):
    """``softmax`` written into ``x``."""
    return x.copy_(softmax(x, axis, dtype))
