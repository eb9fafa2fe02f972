"""Shape ops (counterpart of ``paddle_tpu/tensor/manipulation.py``; the
port has ``reshape``, ``flatten``, ``concat``, ``stack``, ``transpose``,
``split``, ``unbind``, ``squeeze``, ``unsqueeze``, ``expand``, ``tile``,
``flip``, ``gather``, ``gather_nd`` and ``scatter_nd_add``)."""
import torch

from ..amp import amp_cast

__all__ = ['reshape', 'flatten', 'concat', 'stack']


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1)."""
    x, = amp_cast('reshape', x)
    return x.reshape([int(s) for s in shape])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis .. stop_axis`` (inclusive, negative from the
    end) merged into one; a 0-d ``x`` becomes ``[1]``, as
    ``jnp.reshape(v, (-1,))`` makes it."""
    x, = amp_cast('flatten', x)
    nd = x.dim()
    if nd == 0:
        return x.reshape(-1)
    sa, so = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:sa]) + (-1,) + tuple(x.shape[so + 1:]))


def concat(x, axis=0, name=None):
    """The tensors of the list ``x`` joined along ``axis``."""
    x = amp_cast('concat', *x)
    return torch.cat(x, dim=int(axis))


def stack(x, axis=0, name=None):
    """The tensors of the list ``x`` stacked along a new ``axis``."""
    x = amp_cast('stack', *x)
    return torch.stack(x, dim=int(axis))


def _axes(axis):
    return list(axis) if isinstance(axis, (list, tuple)) else [axis]


def transpose(x, perm, name=None):
    x, = amp_cast('transpose', x)
    return x.permute([int(p) for p in perm])


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones
    (the size must divide), or pieces of the listed sizes (one may be
    -1)."""
    x, = amp_cast('split', x)
    axis = int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f'split: axis {axis} size {dim} is not '
                             f'divisible by {num_or_sections}')
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        known = sum(s for s in sizes if s >= 0)
        sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def unbind(input, axis=0):
    x, = amp_cast('unstack', input)
    return list(torch.unbind(x, dim=axis))


def squeeze(x, axis=None, name=None):
    """``x`` without the listed size-1 axes (all of them when None);
    a listed axis of another size stays."""
    x, = amp_cast('squeeze', x)
    if axis is None:
        return x.squeeze()
    axes = [a % x.dim() for a in _axes(axis) if x.shape[a % x.dim()] == 1]
    return x.squeeze(tuple(axes)) if axes else x


def unsqueeze(x, axis, name=None):
    x, = amp_cast('unsqueeze', x)
    for a in sorted(int(a) for a in _axes(axis)):
        x = x.unsqueeze(a)
    return x


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape`` (-1 keeps an axis)."""
    x, = amp_cast('expand', x)
    return x.expand([int(s) for s in shape])


def _int_list(v):
    """An int, a list of ints or a tensor of them as a list of ints."""
    if isinstance(v, torch.Tensor):
        v = v.reshape(-1).tolist()
    return [int(v)] if isinstance(v, int) else [int(r) for r in v]


def tile(x, repeat_times, name=None):
    """``x`` repeated ``repeat_times`` (an int, a list or a tensor)
    along its trailing axes, as ``jnp.tile``."""
    x, = amp_cast('tile', x)
    return x.tile(tuple(_int_list(repeat_times)))


def flip(x, axis, name=None):
    x, = amp_cast('flip', x)
    return torch.flip(x, _axes(axis))


def gather(x, index, axis=0, name=None):
    """Rows ``index`` of ``x`` along ``axis``: the index's shape takes
    the axis's place, so an int index drops the axis, as ``jnp.take``
    does."""
    x, = amp_cast('gather', x)
    axis = int(axis) % x.dim()
    index = torch.as_tensor(index, device=x.device)
    return torch.index_select(x, axis, index.reshape(-1).long()) \
        .reshape(x.shape[:axis] + tuple(index.shape) + x.shape[axis + 1:])


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``."""
    x, = amp_cast('gather_nd', x)
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def scatter_nd_add(x, index, updates, name=None):
    """``x`` with ``updates`` added at the positions ``index[...,
    :k]`` names (repeated positions add up), as the reference's
    ``v.at[...].add(u)``; ``x`` itself is left as it was."""
    x, updates = amp_cast('scatter_nd_add', x, updates)
    index = torch.as_tensor(index, device=x.device).long()
    return x.index_put(tuple(torch.movedim(index, -1, 0)),
                       updates.to(x.dtype), accumulate=True)


__all__ += ['transpose', 'split', 'unbind', 'squeeze', 'unsqueeze',
            'expand', 'tile', 'flip', 'gather', 'gather_nd',
            'scatter_nd_add']
