"""Search, sort and select ops (counterpart of
``paddle_tpu/tensor/search.py``).

Indices are int64 (the reference's are int32 without x64; ``nonzero``
keeps its int32).  The tie orders are the reference's, on both devices:
``topk`` and ``argsort`` come from a stable sort, so ``argsort(...,
descending=True)``, a flip of the ascending order, puts the highest
index first among equal values, ``topk`` the lowest; ``kthvalue``'s
index is the stable argsort's, and ``mode`` gives the smallest of the
most frequent values and its first index.  ``torch.kthvalue`` and
``torch.mode`` promise neither.
"""
import torch

from ..amp import amp_cast
from ._helpers import as_tensor

__all__ = [
    'argmax', 'argmin', 'argsort', 'sort', 'topk', 'where', 'nonzero',
    'index_select', 'index_sample', 'masked_select', 'searchsorted',
    'kthvalue', 'mode',
]


def stable_topk(x, k, dim=-1, largest=True):
    """``torch.topk`` with the reference's tie order: among equal values
    the lowest index comes first, as ``lax.top_k`` gives it.
    ``torch.topk`` promises no order among ties on either device; a
    stable sort, sliced to ``k``, keeps the original order of equal
    values on both."""
    vals, idx = torch.sort(x, dim=dim, descending=largest, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """``(values, int64 indices)`` of the ``k`` largest (or smallest)
    along ``axis``, the lowest index first among equal values."""
    x, = amp_cast('topk', as_tensor(x))
    k = int(k.item()) if torch.is_tensor(k) else int(k)
    return stable_topk(x, k, dim=axis, largest=largest)


def _arg(op):
    def fn(x, axis=None, keepdim=False, dtype='int64', name=None):
        x = as_tensor(x)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if axis is None:
            return op(x)
        return op(x, dim=axis, keepdim=keepdim)
    return fn


argmax = _arg(torch.argmax)
argmax.__doc__ = """Index of the largest element along ``axis`` (of the
    flattened ``x`` when None), the first among equals; a bool ``x``
    compares as 0/1, as ``jnp.argmax`` does."""
argmin = _arg(torch.argmin)


def argsort(x, axis=-1, descending=False, name=None):
    """The stable ascending order along ``axis``, flipped for
    ``descending`` (the highest index first among equal values)."""
    x = as_tensor(x)
    o = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(o, (axis,)) if descending else o


def sort(x, axis=-1, descending=False, name=None):
    x, = amp_cast('sort', as_tensor(x))
    o = torch.sort(x, dim=axis, stable=True)[0]
    return torch.flip(o, (axis,)) if descending else o


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``; with neither, the indices
    of the set elements (``nonzero(condition)``), as in the
    reference."""
    if x is None and y is None:
        return nonzero(condition)
    from .math import _scalar, _weak
    condition = as_tensor(condition)
    if _scalar(x) and not _scalar(y):
        y = as_tensor(y, like=condition)
        x = _weak(x, y)
    elif _scalar(y):
        x = as_tensor(x, like=condition)
        y = _weak(y, x)
    else:
        x, y = as_tensor(x, like=condition), as_tensor(y, like=condition)
    x, y = amp_cast('where', x, y)
    return torch.where(condition.bool(), x, y)


def nonzero(x, as_tuple=False):
    """The indices of the non-zero elements of ``x``: an int32
    ``[n, x.dim()]`` tensor, or with ``as_tuple`` one int32 ``[n]``
    tensor per axis, as the reference returns them.  The count is the
    data's, so this reads it back to the host, as the reference does."""
    nz = torch.nonzero(as_tensor(x), as_tuple=True)
    if as_tuple:
        return tuple(i.to(torch.int32) for i in nz)
    return torch.stack(nz, dim=1).to(torch.int32)


def index_select(x, index, axis=0, name=None):
    """Rows ``index`` of ``x`` along ``axis`` (``jnp.take``)."""
    from .manipulation import gather
    return gather(x, index, axis)


def index_sample(x, index):
    """``x[i, index[i, j]]`` for a 2-D ``x``."""
    x, = amp_cast('index_sample', as_tensor(x))
    return torch.gather(x, 1, as_tensor(index, like=x).long())


def masked_select(x, mask, name=None):
    """The elements of ``x`` where ``mask`` (broadcast to x) is set, as a
    1-D tensor; the count is the data's (a read back to the host)."""
    x = as_tensor(x)
    mask = as_tensor(mask, like=x).bool()
    return x[mask.expand(x.shape)]


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = as_tensor(sorted_sequence)
    return torch.searchsorted(s, as_tensor(values, like=s), right=right,
                              out_int32=out_int32)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index in the
    stable ascending order."""
    x, = amp_cast('kthvalue', as_tensor(x))
    idx = torch.argsort(x, dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.gather(x, axis, idx)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its first occurrence."""
    x, = amp_cast('mode', as_tensor(x))
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    sv = torch.sort(xm, dim=-1)[0]
    runs = torch.cat([torch.ones_like(sv[..., :1], dtype=torch.bool),
                      sv[..., 1:] != sv[..., :-1]], dim=-1)
    run_id = torch.cumsum(runs.long(), dim=-1) - 1
    counts = torch.zeros(sv.shape[:-1] + (n,), dtype=torch.long,
                         device=x.device).scatter_add_(
        -1, run_id, torch.ones_like(run_id))
    best = torch.argmax(counts, dim=-1, keepdim=True)
    first = torch.argmax((run_id == best).to(torch.uint8), dim=-1,
                         keepdim=True)
    val = torch.gather(sv, -1, first)
    idx = torch.argmax((xm == val).to(torch.uint8), dim=-1, keepdim=True)
    vals = torch.gather(xm, -1, idx)
    if keepdim:
        return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)
    return vals[..., 0], idx[..., 0]
