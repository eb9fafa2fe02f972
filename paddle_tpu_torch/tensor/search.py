"""Search ops (counterpart of ``paddle_tpu/tensor/search.py``; the port
has ``topk``, ``argmax``, ``where`` and ``nonzero``)."""
import torch

from ..amp import amp_cast

__all__ = ['topk', 'argmax', 'where', 'nonzero']


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
    x, = amp_cast('topk', x)
    k = int(k.item()) if torch.is_tensor(k) else int(k)
    return stable_topk(x, k, dim=axis, largest=largest)


def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    """Index of the largest element along ``axis`` (of the flattened
    ``x`` when None), the first among equals; a bool ``x`` compares as
    0/1, as ``jnp.argmax`` does."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if axis is None:
        return torch.argmax(x)
    return torch.argmax(x, dim=axis, keepdim=keepdim)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``; with neither, the indices
    of the set elements (``nonzero(condition)``), as in the
    reference."""
    if x is None and y is None:
        return nonzero(condition)
    x, y = amp_cast('where', x, y)
    return torch.where(condition.bool(), x, y)


def nonzero(x, as_tuple=False):
    """The indices of the non-zero elements of ``x``: an int32
    ``[n, x.dim()]`` tensor, or with ``as_tuple`` one int32 ``[n]``
    tensor per axis, as the reference returns them.  The count is the
    data's, so this reads it back to the host, as the reference does."""
    nz = torch.nonzero(torch.as_tensor(x), as_tuple=True)
    if as_tuple:
        return tuple(i.to(torch.int32) for i in nz)
    return torch.stack(nz, dim=1).to(torch.int32)
