"""Arithmetic and reductions (counterpart of ``paddle_tpu/tensor/math.py``;
the port has ``add``, ``subtract``, ``multiply`` and ``sum``).  A
Python scalar operand stays a scalar, so it takes the tensor's dtype,
as in the reference."""
import torch

from ..amp import amp_cast

__all__ = ['add', 'subtract', 'multiply', 'sum']


def _binary(op, name):
    def fn(x, y, name=None):
        if isinstance(y, torch.Tensor) and isinstance(x, torch.Tensor):
            x, y = amp_cast(name, x, y)
        elif isinstance(x, torch.Tensor):
            x, = amp_cast(name, x)
        else:
            y, = amp_cast(name, y)
        return op(x, y)
    fn.__name__ = name
    return fn


add = _binary(torch.add, 'add')
subtract = _binary(torch.sub, 'subtract')
multiply = _binary(torch.mul, 'multiply')


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """Sum over ``axis`` (an int, a list, or None for every axis) in
    ``dtype`` (a name or a torch dtype); in f32 under AMP (``sum`` is
    black-listed).  With no ``dtype`` a bool or integer tensor sums to
    int32, as the reference's 32-bit integers do."""
    x, = amp_cast('sum', x)
    if isinstance(axis, int):
        axis = (axis,)
    if dtype is None and not x.is_floating_point() \
            and not x.is_complex():
        dtype = torch.int32
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return x.sum(dim=axis, keepdim=keepdim, dtype=dtype)


def mean(x, axis=None, keepdim=False, name=None):
    """Mean over ``axis`` (an int, a list, or None for every axis); in
    f32 under AMP (``mean`` is black-listed).  A bool or integer tensor
    averages in float32, as the reference's ``jnp.mean`` does."""
    x, = amp_cast('mean', x)
    if not x.is_floating_point() and not x.is_complex():
        x = x.float()
    if isinstance(axis, int):
        axis = (axis,)
    return x.mean(dim=axis, keepdim=keepdim)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, either side transposed on its last two axes first
    (white-listed: low precision under AMP)."""
    x, y = amp_cast('matmul', x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


__all__ += ['mean', 'matmul']


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``).  The Python
    scalars meet ``x`` as the reference's weakly typed constants do: on
    a float tensor they round to its dtype first; a bool or integer
    tensor goes to float32 where either scalar is a float, and else
    keeps its integer dtype (int32 for bool)."""
    from ..nn.functional.norm import _scalar
    x, = amp_cast('scale', x)
    if x.is_floating_point():
        s, b = _scalar(scale, x.dtype), _scalar(bias, x.dtype)
    else:
        s, b = scale, bias
        if any(isinstance(v, float) for v in (s, b)):
            x = x.to(torch.float32)
        elif x.dtype == torch.bool:
            x = x.to(torch.int32)
    return x * s + b if bias_after_scale else (x + b) * s


__all__ += ['scale']
