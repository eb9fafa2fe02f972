"""Linear algebra (counterpart of ``paddle_tpu/tensor/linalg.py``).

``matmul`` lives in ``math`` (the port's models reach it there);
``norm`` and ``dist`` spell out the reference's formulas; ``cross``'s
default ``axis=9`` names the first axis of size 3; ``histogram`` with
``min = max = 0`` takes the data's range.  Counts and ranks are int64.
"""
import numpy as np
import torch

from ..amp import amp_cast
from ._helpers import as_tensor
from .math import matmul

__all__ = [
    'matmul', 'mm', 'bmm', 'dot', 'mv', 't', 'norm', 'dist', 'cross',
    'cholesky', 'matrix_power', 'histogram', 'einsum', 'inv', 'det',
    'slogdet', 'svd', 'solve', 'qr', 'eigh', 'pinv', 'multi_dot',
    'triangular_solve', 'cond', 'matrix_rank', 'inverse',
]

mm = matmul


def bmm(x, y, name=None):
    a, b = amp_cast('bmm', as_tensor(x), as_tensor(y))
    return torch.matmul(a, b)


def dot(x, y, name=None):
    """``sum(x * y)`` over the last axis."""
    a, b = amp_cast('dot', as_tensor(x), as_tensor(y))
    return (a * b).sum(dim=-1)


def mv(x, vec, name=None):
    a, b = amp_cast('mv', as_tensor(x), as_tensor(vec))
    return torch.matmul(a, b)


def t(input, name=None):
    x = as_tensor(input)
    if x.dim() > 2:
        raise ValueError(
            'paddle.t only supports tensors of rank <= 2; use transpose')
    return x.t() if x.dim() == 2 else x


def _dims(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p='fro', axis=None, keepdim=False, name=None):
    """The ``p``-norm over ``axis`` (every element when None): ``'fro'``,
    ``inf``, ``-inf``, ``0`` (the count of non-zeros) or a number."""
    v, = amp_cast('norm', as_tensor(x))
    if p == 'fro' and axis is None:
        return torch.sqrt(torch.sum(torch.square(v)))
    ax = _dims(axis)
    kw = dict(dim=ax, keepdim=keepdim) if ax is not None else {}
    if p == 'fro':
        return torch.sqrt(torch.sum(torch.square(v), **kw))
    if p == np.inf:
        return torch.amax(torch.abs(v), **kw)
    if p == -np.inf:
        return torch.amin(torch.abs(v), **kw)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), **kw)
    return torch.pow(torch.sum(torch.pow(torch.abs(v), p), **kw), 1.0 / p)


def dist(x, y, p=2, name=None):
    """The ``p``-norm of ``x - y`` over every element."""
    a, b = amp_cast('dist', as_tensor(x), as_tensor(y))
    d = a - b
    if p == np.inf:
        return torch.amax(torch.abs(d))
    if p == -np.inf:
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


def cross(x, y, axis=9, name=None):
    a, b = amp_cast('cross', as_tensor(x), as_tensor(y))
    if axis == 9:
        sizes = [i for i, s in enumerate(a.shape) if s == 3]
        if not sizes:
            raise ValueError('no axis of size 3 for cross')
        axis = sizes[0]
    return torch.linalg.cross(a, b, dim=axis)


def cholesky(x, upper=False, name=None):
    x, = amp_cast('cholesky', as_tensor(x))
    return torch.linalg.cholesky(x, upper=upper)


def matrix_power(x, n, name=None):
    x, = amp_cast('matrix_power', as_tensor(x))
    return torch.linalg.matrix_power(x, n)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``input`` in ``bins`` equal bins over ``[min, max]`` (the
    data's range when both are 0), the last bin closed."""
    x = as_tensor(input)
    return torch.histc(x.float(), bins=bins, min=min, max=max) \
        .to(torch.int64)


def einsum(equation, *operands):
    ts = amp_cast('einsum', *[as_tensor(o) for o in operands])
    return torch.einsum(equation, *ts)


def inv(x, name=None):
    x, = amp_cast('inv', as_tensor(x))
    return torch.linalg.inv(x)


inverse = inv


def det(x, name=None):
    x, = amp_cast('det', as_tensor(x))
    return torch.linalg.det(x)


def slogdet(x, name=None):
    x, = amp_cast('slogdet', as_tensor(x))
    return tuple(torch.linalg.slogdet(x))


def svd(x, full_matrices=False, name=None):
    """``(U, S, Vh)``."""
    x, = amp_cast('svd', as_tensor(x))
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def qr(x, mode='reduced', name=None):
    x, = amp_cast('qr', as_tensor(x))
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == 'r' else (q, r)


def eigh(x, UPLO='L', name=None):
    x, = amp_cast('eigh', as_tensor(x))
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    x, = amp_cast('pinv', as_tensor(x))
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    a, b = amp_cast('solve', as_tensor(x), as_tensor(y))
    return torch.linalg.solve(a, b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """``x^-1 y`` (``x^-T y`` with ``transpose``) for a triangular ``x``
    (its upper or lower triangle)."""
    a, b = amp_cast('triangular_solve', as_tensor(x), as_tensor(y))
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def multi_dot(x, name=None):
    ts = amp_cast('multi_dot', *[as_tensor(t_) for t_ in x])
    return torch.linalg.multi_dot(ts)


def cond(x, p=None, name=None):
    x, = amp_cast('cond', as_tensor(x))
    return torch.linalg.cond(x, p)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (by default the
    largest times ``max(M, N)`` times the dtype's epsilon)."""
    x, = amp_cast('matrix_rank', as_tensor(x))
    if tol is None:
        return torch.linalg.matrix_rank(x, hermitian=hermitian)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                    hermitian=hermitian)
