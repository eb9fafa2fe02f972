"""Comparison and logic ops (counterpart of
``paddle_tpu/tensor/logic.py``; the port has ``equal``, ``not_equal``,
the ``logical_*`` ops and ``all``); each returns a bool tensor."""
import torch

__all__ = ['equal', 'not_equal', 'logical_and', 'logical_or',
           'logical_xor', 'logical_not', 'all']


def equal(x, y, name=None):
    return torch.eq(x, y)


def not_equal(x, y, name=None):
    return torch.ne(x, y)


def _operands(x, y):
    """Both operands as tensors: a Python or numpy value beside a
    tensor becomes one on its device (its truth is what counts), as the
    reference's ``jnp`` ops take scalars."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=getattr(y, 'device', None))
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=x.device)
    return x, y


def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*_operands(x, y))


def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*_operands(x, y))


def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*_operands(x, y))


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def all(x, axis=None, keepdim=False, name=None):
    if axis is None:
        return torch.all(x)
    return torch.all(x, dim=axis, keepdim=keepdim)
