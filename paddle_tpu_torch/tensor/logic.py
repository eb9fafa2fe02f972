"""Comparison, logic and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``).  Each returns a bool tensor (the
bitwise ops the operands' dtype); a Python or numpy operand beside a
tensor becomes one on its device.  ``allclose``, ``equal_all`` and
``is_empty`` return a 0-d bool tensor, as the reference does."""
import torch

from ._helpers import as_tensor

__all__ = [
    'equal', 'not_equal', 'greater_than', 'greater_equal', 'less_than',
    'less_equal', 'logical_and', 'logical_or', 'logical_not', 'logical_xor',
    'allclose', 'isclose', 'equal_all', 'is_empty', 'is_tensor',
    'bitwise_and', 'bitwise_or', 'bitwise_xor', 'bitwise_not',
]


def _operand(v, device):
    """A Python scalar as a 0-d tensor filled on ``device`` (no host
    copy, so a CUDA graph can capture it), a numpy value or a list as a
    tensor there."""
    if isinstance(v, (bool, int, float)):
        return torch.full((), v, device=device)
    return torch.as_tensor(v, device=device)


def _operands(x, y):
    """Both operands as tensors: a Python or numpy value beside a
    tensor becomes one on its device (its truth is what counts), as the
    reference's ``jnp`` ops take scalars."""
    if not isinstance(x, torch.Tensor):
        x = _operand(x, getattr(y, 'device', None))
    if not isinstance(y, torch.Tensor):
        y = _operand(y, x.device)
    return x, y


def _cmp(op, name):
    def fn(x, y, name=None):
        return op(*_operands(x, y))
    fn.__name__ = name
    return fn


equal = _cmp(torch.eq, 'equal')
not_equal = _cmp(torch.ne, 'not_equal')
greater_than = _cmp(torch.gt, 'greater_than')
greater_equal = _cmp(torch.ge, 'greater_equal')
less_than = _cmp(torch.lt, 'less_than')
less_equal = _cmp(torch.le, 'less_equal')
bitwise_and = _cmp(torch.bitwise_and, 'bitwise_and')
bitwise_or = _cmp(torch.bitwise_or, 'bitwise_or')
bitwise_xor = _cmp(torch.bitwise_xor, 'bitwise_xor')


def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*_operands(x, y))


def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*_operands(x, y))


def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*_operands(x, y))


def logical_not(x, out=None, name=None):
    return torch.logical_not(as_tensor(x))


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(as_tensor(x))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _operands(x, y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol, atol,
                                       equal_nan), device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _operands(x, y)
    return torch.isclose(x, y.to(x.dtype), rtol, atol, equal_nan)


def equal_all(x, y, name=None):
    x, y = _operands(x, y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(
        x, y.to(x.dtype))), device=x.device)


def is_empty(x, name=None):
    x = as_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
