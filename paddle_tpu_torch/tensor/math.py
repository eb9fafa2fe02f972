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


def sum(x, axis=None, keepdim=False, name=None):
    """Sum over ``axis`` (an int, a list, or None for every axis); in
    f32 under AMP (``sum`` is black-listed)."""
    x, = amp_cast('sum', x)
    if isinstance(axis, int):
        axis = (axis,)
    return x.sum(dim=axis, keepdim=keepdim)
