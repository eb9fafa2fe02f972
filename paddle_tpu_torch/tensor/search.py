"""Search ops (counterpart of ``paddle_tpu/tensor/search.py``; the port
has ``topk``, ``argmax`` and ``where``)."""
import torch

from ..amp import amp_cast

__all__ = ['topk', 'argmax', 'where']


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """``(values, int64 indices)`` of the ``k`` largest (or smallest)
    along ``axis``."""
    x, = amp_cast('topk', x)
    vals, idx = torch.topk(x, int(k), dim=axis, largest=largest,
                           sorted=True)
    return vals, idx


def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    if axis is None:
        return torch.argmax(x)
    return torch.argmax(x, dim=axis, keepdim=keepdim)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``."""
    x, y = amp_cast('where', x, y)
    return torch.where(condition.bool(), x, y)
