"""Elementwise ops and reductions (counterpart of
``paddle_tpu/tensor/math.py``).

Each op casts its float inputs through the AMP policy under the
reference's op name.  A Python scalar operand stays a scalar, so it
takes the tensor's dtype (a float scalar beside an integer tensor makes
it float32), as the reference's weakly typed constants do.  Integer
sums, products and cumulative sums over the reference's 32-bit
integers (bool to int32) stay int32; ``max``/``amax`` and ``min``/
``amin`` split the gradient evenly among tied extremes, as JAX's do.
The ``*_`` ops write into their first argument and return it.
"""
import builtins
import functools

import numpy as np
import torch

from ..amp import amp_cast
from ..core.dtype import convert_dtype
from ._helpers import as_tensor, axes_of, narrow_int, raw

__all__ = ['add', 'subtract', 'multiply', 'sum']


def _scalar(v):
    return isinstance(v, (int, float, bool, np.number))


@functools.lru_cache(maxsize=1024)
def _rounded(v, dtype):
    return torch.tensor(v, dtype=dtype).item()


def _weak(v, other):
    """A Python scalar beside the tensor ``other``, kept a Python number:
    torch types it as the reference types a weakly typed constant (the
    tensor's dtype where the kinds agree, float32 for a float beside an
    integer tensor).  Beside a bf16 or f16 tensor it is rounded to that
    dtype first, as the reference rounds the constant (torch would keep
    it in f32 inside the op)."""
    if isinstance(v, np.generic):
        v = v.item()
    if other.dtype in (torch.bfloat16, torch.float16) \
            and not isinstance(v, bool):
        return _rounded(v, other.dtype)
    return v


def _weak_tensor(v, other):
    """``_weak(v, other)`` as a 0-d tensor of the dtype torch gives the
    pair, filled on the device (no host copy, so a CUDA graph captures
    it), for the ops that take no Python number."""
    v = _weak(v, other)
    return torch.full((), v, dtype=torch.result_type(other, v),
                      device=other.device)


def _binary(op, name, numbers=True):
    """The op ``name``; ``numbers``: ``op`` takes a Python number on
    either side."""
    weak = _weak if numbers else _weak_tensor

    def fn(x, y, name=None):
        if _scalar(y) and not _scalar(x):
            x, = amp_cast(name, as_tensor(x))
            return op(x, weak(y, x))
        if _scalar(x) and not _scalar(y):
            y, = amp_cast(name, as_tensor(y))
            return op(weak(x, y), y)
        x = as_tensor(x)
        x, y = amp_cast(name, x, as_tensor(y, like=x))
        return op(x, y)
    fn.__name__ = name
    return fn


def _constant(op):
    """``op`` with a zero gradient, as JAX gives ``floor_divide`` and
    ``heaviside`` (PyTorch defines none)."""
    def fn(x, y):
        with torch.no_grad():
            return op(x, y)
    return fn


def _fmax(x, y):
    # JAX's select: a tie takes y (its gradient too), a NaN y takes x
    return torch.where((x > y) | torch.isnan(y), x, y)


def _fmin(x, y):
    return torch.where((x < y) | torch.isnan(y), x, y)


add = _binary(torch.add, 'add')
subtract = _binary(torch.sub, 'subtract')
multiply = _binary(torch.mul, 'multiply')
divide = _binary(torch.true_divide, 'divide')
floor_divide = _binary(_constant(torch.floor_divide), 'floor_divide')
mod = _binary(torch.remainder, 'mod', numbers=False)
remainder = mod
floor_mod = mod
maximum = _binary(torch.maximum, 'maximum', numbers=False)
minimum = _binary(torch.minimum, 'minimum', numbers=False)
fmax = _binary(_fmax, 'fmax', numbers=False)
fmin = _binary(_fmin, 'fmin', numbers=False)
atan2 = _binary(torch.atan2, 'atan2', numbers=False)
heaviside = _binary(_constant(torch.heaviside), 'heaviside', numbers=False)
gcd = _binary(torch.gcd, 'gcd', numbers=False)
lcm = _binary(torch.lcm, 'lcm', numbers=False)


def pow(x, y, name=None):
    """``x ** y`` (``float_power`` is the same op, as in the
    reference)."""
    x = as_tensor(x)
    if _scalar(y):
        x, = amp_cast('pow', x)
        return torch.pow(x, y)
    x, y = amp_cast('pow', x, as_tensor(y, like=x))
    return torch.pow(x, y)


float_power = pow


def _unary(op, name):
    def fn(x, name=None):
        x, = amp_cast(name, as_tensor(x))
        return op(x)
    fn.__name__ = name
    return fn


def _round_away(v):
    # the reference rounds half away from zero; torch.round is half-even
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


exp = _unary(torch.exp, 'exp')
expm1 = _unary(torch.expm1, 'expm1')
log = _unary(torch.log, 'log')
log2 = _unary(torch.log2, 'log2')
log10 = _unary(torch.log10, 'log10')
log1p = _unary(torch.log1p, 'log1p')
sqrt = _unary(torch.sqrt, 'sqrt')
rsqrt = _unary(torch.rsqrt, 'rsqrt')
square = _unary(torch.square, 'square')
abs = _unary(torch.abs, 'abs')
sign = _unary(torch.sign, 'sign')
sgn = sign
sin = _unary(torch.sin, 'sin')
cos = _unary(torch.cos, 'cos')
tan = _unary(torch.tan, 'tan')
asin = _unary(torch.asin, 'asin')
acos = _unary(torch.acos, 'acos')
atan = _unary(torch.atan, 'atan')
sinh = _unary(torch.sinh, 'sinh')
cosh = _unary(torch.cosh, 'cosh')
tanh = _unary(torch.tanh, 'tanh')
asinh = _unary(torch.asinh, 'asinh')
acosh = _unary(torch.acosh, 'acosh')
atanh = _unary(torch.atanh, 'atanh')
reciprocal = _unary(torch.reciprocal, 'reciprocal')
floor = _unary(torch.floor, 'floor')
ceil = _unary(torch.ceil, 'ceil')
round = _unary(_round_away, 'round')
trunc = _unary(torch.trunc, 'trunc')
erf = _unary(torch.erf, 'erf')
erfinv = _unary(torch.erfinv, 'erfinv')
digamma = _unary(torch.digamma, 'digamma')
lgamma = _unary(torch.lgamma, 'lgamma')
frac = _unary(lambda v: v - torch.trunc(v), 'frac')
rad2deg = _unary(torch.rad2deg, 'rad2deg')
deg2rad = _unary(torch.deg2rad, 'deg2rad')
angle = _unary(torch.angle, 'angle')
isfinite = _unary(torch.isfinite, 'isfinite')
isinf = _unary(torch.isinf, 'isinf')
isnan = _unary(torch.isnan, 'isnan')
conj = _unary(lambda v: torch.conj(v).resolve_conj(), 'conj')
real = _unary(torch.real, 'real')
imag = _unary(_imag, 'imag')


def logit(x, eps=None, name=None):
    x, = amp_cast('logit', as_tensor(x))
    u = x if eps is None else torch.clamp(x, eps, 1 - eps)
    return torch.log(u / (1 - u))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x, = amp_cast('nan_to_num', as_tensor(x))
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def clip(x, min=None, max=None, name=None):
    x, = amp_cast('clip', as_tensor(x))
    return torch.clamp(x, raw(min), raw(max))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """``scale_b * tanh(scale_a * x)``."""
    x, = amp_cast('stanh', as_tensor(x))
    return scale_b * torch.tanh(scale_a * x)


def _reduce_dims(x, axis):
    return axes_of(axis, x.dim()) if x.dim() else ()


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Sum over ``axis`` (an int, a list, or None for every axis) in
    ``dtype`` (a name or a torch dtype); in f32 under AMP (``sum`` is
    black-listed).  With no ``dtype`` a bool or integer tensor sums to
    int32, as the reference's 32-bit integers do."""
    x, = amp_cast('sum', as_tensor(x))
    if isinstance(axis, int):
        axis = (axis,)
    if dtype is None and not x.is_floating_point() \
            and not x.is_complex():
        dtype = torch.int32
    return x.sum(dim=axis, keepdim=keepdim, dtype=convert_dtype(dtype))


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x, = amp_cast('prod', as_tensor(x))
    d = convert_dtype(dtype)
    out = x if d is None else x.to(d)
    for a in sorted(_reduce_dims(x, axis), reverse=True):
        out = out.prod(dim=a, keepdim=keepdim)
    if d is None and not x.dim():
        out = out.clone()
    return out if d is not None else narrow_int(out, x)


def _extreme(op, name):
    def fn(x, axis=None, keepdim=False, name=None):
        x, = amp_cast(name, as_tensor(x))
        dims = _reduce_dims(x, axis)
        return op(x, dim=dims, keepdim=keepdim) if dims else op(x)
    fn.__name__ = name
    return fn


max = _extreme(torch.amax, 'max')
min = _extreme(torch.amin, 'min')
amax = max
amin = min


def _logical(op, name):
    def fn(x, axis=None, keepdim=False, name=None):
        x = as_tensor(x)
        dims = _reduce_dims(x, axis)
        return op(x, dim=dims, keepdim=keepdim) if dims else op(x)
    fn.__name__ = name
    return fn


all = _logical(torch.all, 'all')
any = _logical(torch.any, 'any')


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    dims = _reduce_dims(x, axis)
    out = torch.count_nonzero(x, dim=dims) if dims else \
        torch.count_nonzero(x)
    if keepdim:
        for a in sorted(dims):
            out = out.unsqueeze(a)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    """Running sum along ``axis`` (of the flattened ``x`` when None).
    ``dtype`` is taken and ignored, as in the reference; a 32-bit or
    narrower integer input sums in int32."""
    x, = amp_cast('cumsum', as_tensor(x))
    v = x.reshape(-1) if axis is None else x
    return narrow_int(torch.cumsum(v, dim=0 if axis is None else int(axis)),
                      x)


def cumprod(x, dim=None, dtype=None, name=None):
    x, = amp_cast('cumprod', as_tensor(x))
    v = x.reshape(-1) if dim is None else x
    return narrow_int(torch.cumprod(v, dim=0 if dim is None else int(dim)),
                      x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x, = amp_cast('logsumexp', as_tensor(x))
    return torch.logsumexp(x, dim=_reduce_dims(x, axis), keepdim=keepdim)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = amp_cast('addmm', as_tensor(input), as_tensor(x),
                       as_tensor(y))
    return beta * i + alpha * torch.matmul(a, b)


def inner(x, y, name=None):
    a, b = amp_cast('inner', as_tensor(x), as_tensor(y))
    return torch.inner(a, b)


def outer(x, y, name=None):
    """The outer product of the flattened inputs."""
    a, b = amp_cast('outer', as_tensor(x), as_tensor(y))
    return torch.outer(a.reshape(-1), b.reshape(-1))


def kron(x, y, name=None):
    a, b = amp_cast('kron', as_tensor(x), as_tensor(y))
    return torch.kron(a, b)


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)``."""
    if _scalar(weight):
        a, b = amp_cast('lerp', as_tensor(x), as_tensor(y))
        return a + weight * (b - a)
    a, b, w = amp_cast('lerp', as_tensor(x), as_tensor(y),
                       as_tensor(weight))
    return a + w * (b - a)


def mean(x, axis=None, keepdim=False, name=None):
    """Mean over ``axis`` (an int, a list, or None for every axis); in
    f32 under AMP (``mean`` is black-listed).  A bool or integer tensor
    averages in float32, as the reference's ``jnp.mean`` does."""
    x, = amp_cast('mean', as_tensor(x))
    if not x.is_floating_point() and not x.is_complex():
        x = x.float()
    if isinstance(axis, int):
        axis = (axis,)
    return x.mean(dim=axis, keepdim=keepdim)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, either side transposed on its last two axes first
    (white-listed: low precision under AMP)."""
    x, y = amp_cast('matmul', as_tensor(x), as_tensor(y))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``).  The Python
    scalars meet ``x`` as the reference's weakly typed constants do: on
    a float tensor they round to its dtype first; a bool or integer
    tensor goes to float32 where either scalar is a float, and else
    keeps its integer dtype (int32 for bool)."""
    from ..nn.functional.norm import _scalar as _as_dtype
    x, = amp_cast('scale', as_tensor(x))
    scale, bias = raw(scale), raw(bias)
    if x.is_floating_point():
        s, b = _as_dtype(scale, x.dtype), _as_dtype(bias, x.dtype)
    else:
        s, b = scale, bias
        if builtins.any(isinstance(v, float) for v in (s, b)):
            x = x.to(torch.float32)
        elif x.dtype == torch.bool:
            x = x.to(torch.int32)
    return x * s + b if bias_after_scale else (x + b) * s


def increment(x, value=1.0, name=None):
    """``x + value``, written into ``x``."""
    return x.add_(value)


def diff(x, n=1, axis=-1, name=None):
    x, = amp_cast('diff', as_tensor(x))
    return torch.diff(x, n=n, dim=axis)


def take(x, index, mode='raise', name=None):
    """Elements of the flattened ``x`` at ``index`` (in its shape);
    ``mode`` ``'wrap'`` or ``'clip'`` folds an index outside the range.
    ``'raise'`` (the default) raises, as the reference's ``jnp.take``
    does."""
    if mode == 'raise':
        raise NotImplementedError("take: mode 'raise' is not supported, "
                                  "as in the reference; pass 'wrap' or "
                                  "'clip'")
    x, = amp_cast('take', as_tensor(x))
    idx = as_tensor(index, like=x).long()
    n = x.numel()
    if mode == 'wrap':
        idx = torch.remainder(idx, n)
    elif mode == 'clip':
        idx = idx.clamp(0, n - 1)
    return torch.take(x, idx)


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]`` for each row ``i``."""
    vs = amp_cast('multiplex', *[as_tensor(v) for v in inputs])
    stacked = torch.stack(vs, dim=0)
    sel = as_tensor(index, like=stacked).reshape(-1).long()
    return stacked[sel, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if not isinstance(inputs, (list, tuple)):
        return as_tensor(inputs).clone()
    out = as_tensor(inputs[0])
    for t in inputs[1:]:
        out = add(out, t)
    return out


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x, = amp_cast('trace', as_tensor(x))
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def broadcast_shape(x_shape, y_shape):
    """The broadcast of two shapes, as a list (no tensors)."""
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def multiply_(x, y):
    return x.mul_(y)


def add_(x, y, name=None):
    return x.add_(y)


def subtract_(x, y, name=None):
    return x.sub_(y)


def clip_(x, min=None, max=None, name=None):
    return x.clamp_(raw(min), raw(max))


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    scale, bias = raw(scale), raw(bias)
    if bias_after_scale:
        return x.mul_(scale).add_(bias)
    return x.add_(bias).mul_(scale)


def tanh_(x, name=None):
    return x.tanh_()


def exp_(x, name=None):
    return x.exp_()


def ceil_(x, name=None):
    return x.ceil_()


def floor_(x, name=None):
    return x.floor_()


def reciprocal_(x, name=None):
    return x.reciprocal_()


def round_(x, name=None):
    # half away from zero has no in-place torch op; its gradient is 0
    with torch.no_grad():
        return x.copy_(round(x))


def rsqrt_(x, name=None):
    return x.rsqrt_()


def sqrt_(x, name=None):
    return x.sqrt_()


__all__ += [
    'divide', 'floor_divide', 'mod', 'remainder', 'pow', 'float_power',
    'maximum', 'minimum', 'fmax', 'fmin', 'exp', 'expm1', 'log', 'log2',
    'log10', 'log1p', 'sqrt', 'rsqrt', 'square', 'abs', 'sign', 'sin',
    'cos', 'tan', 'asin', 'acos', 'atan', 'atan2', 'sinh', 'cosh', 'tanh',
    'asinh', 'acosh', 'atanh', 'reciprocal', 'floor', 'ceil', 'round',
    'trunc', 'clip', 'prod', 'max', 'min', 'amax', 'amin', 'cumsum',
    'cumprod', 'logsumexp', 'logit', 'erf', 'erfinv', 'multiply_', 'addmm',
    'inner', 'outer', 'kron', 'isfinite', 'isinf', 'isnan', 'nan_to_num',
    'lerp', 'scale', 'increment', 'any', 'heaviside', 'frac', 'rad2deg',
    'deg2rad', 'gcd', 'lcm', 'diff', 'angle', 'count_nonzero', 'sgn',
    'take', 'digamma', 'lgamma', 'floor_mod', 'stanh', 'multiplex',
    'add_', 'subtract_', 'clip_', 'scale_', 'tanh_', 'add_n', 'trace',
    'conj', 'real', 'imag', 'broadcast_shape', 'exp_', 'ceil_', 'floor_',
    'reciprocal_', 'round_', 'rsqrt_', 'sqrt_', 'mean', 'matmul', 'all']
