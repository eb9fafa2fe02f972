"""Shape, layout, gather and scatter ops (counterpart of
``paddle_tpu/tensor/manipulation.py``).

``scatter(overwrite=False)`` adds the updates into ``x``, as the
reference does (the original Paddle zeroes the rows first); ``unique``
returns the sorted values with the reference's ``return_*`` outputs;
``cast`` keeps the true widths (``'int64'`` is int64).  The ``*_`` ops
change their first argument in place and return it.
"""
import builtins

import torch

from ..amp import amp_cast
from ..core.dtype import convert_dtype
from ._helpers import as_tensor, raw, shape_of

__all__ = [
    'reshape', 'flatten', 'transpose', 'concat', 'split', 'chunk', 'stack',
    'unstack', 'squeeze', 'unsqueeze', 'expand', 'expand_as', 'tile',
    'broadcast_to', 'flip', 'roll', 'gather', 'gather_nd', 'scatter',
    'scatter_nd_add', 'unbind', 'unique', 'moveaxis', 'repeat_interleave',
    'take_along_axis', 'put_along_axis', 'numel', 'cast', 'slice',
    'strided_slice', 'rot90', 'as_strided', 'view', 'tolist',
    'tensordot', 'atleast_1d', 'atleast_2d', 'atleast_3d',
    'reverse', 'crop', 'scatter_nd', 'shard_index', 'shape', 'rank',
    'reshape_', 'flatten_', 'squeeze_', 'unsqueeze_', 'scatter_',
]


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1)."""
    x, = amp_cast('reshape', as_tensor(x))
    return x.reshape(shape_of(shape))


def view(x, shape_or_dtype, name=None):
    return reshape(x, shape_or_dtype)


def _flat_shape(x, start_axis, stop_axis):
    nd = x.dim()
    if nd == 0:
        return (-1,)
    sa, so = start_axis % nd, stop_axis % nd
    return tuple(x.shape[:sa]) + (-1,) + tuple(x.shape[so + 1:])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis .. stop_axis`` (inclusive, negative from the
    end) merged into one; a 0-d ``x`` becomes ``[1]``, as
    ``jnp.reshape(v, (-1,))`` makes it."""
    x, = amp_cast('flatten', as_tensor(x))
    return x.reshape(_flat_shape(x, start_axis, stop_axis))


def transpose(x, perm, name=None):
    x, = amp_cast('transpose', as_tensor(x))
    return x.permute([int(p) for p in perm])


def moveaxis(x, source, destination, name=None):
    x, = amp_cast('moveaxis', as_tensor(x))
    return torch.movedim(x, source, destination)


def concat(x, axis=0, name=None):
    """The tensors of the list ``x`` joined along ``axis``."""
    x = amp_cast('concat', *[as_tensor(t) for t in x])
    return torch.cat(x, dim=int(raw(axis)))


def stack(x, axis=0, name=None):
    """The tensors of the list ``x`` stacked along a new ``axis``."""
    x = amp_cast('stack', *[as_tensor(t) for t in x])
    return torch.stack(x, dim=int(axis))


def _axes(axis):
    return list(axis) if isinstance(axis, (list, tuple)) else [axis]


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones
    (the size must divide), or pieces of the listed sizes (one may be
    -1)."""
    x, = amp_cast('split', as_tensor(x))
    axis = int(raw(axis))
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f'split: axis {axis} size {dim} is not '
                             f'divisible by {num_or_sections}')
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(raw(s)) for s in num_or_sections]
        known = builtins.sum(s for s in sizes if s >= 0)
        sizes = [s if s >= 0 else dim - known for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unstack(x, axis=0, num=None, name=None):
    x, = amp_cast('unstack', as_tensor(x))
    return list(torch.unbind(x, dim=axis))


def unbind(input, axis=0):
    return unstack(input, axis)


def squeeze(x, axis=None, name=None):
    """``x`` without the listed size-1 axes (all of them when None);
    a listed axis of another size stays."""
    x, = amp_cast('squeeze', as_tensor(x))
    if axis is None:
        return x.squeeze()
    axes = [a % x.dim() for a in _axes(axis) if x.shape[a % x.dim()] == 1]
    return x.squeeze(tuple(axes)) if axes else x


def unsqueeze(x, axis, name=None):
    x, = amp_cast('unsqueeze', as_tensor(x))
    for a in sorted(int(raw(a)) for a in _axes(axis)):
        x = x.unsqueeze(a)
    return x


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape`` (-1 keeps an axis)."""
    x, = amp_cast('expand', as_tensor(x))
    return x.expand(shape_of(shape))


def expand_as(x, y, name=None):
    return expand(x, as_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def tile(x, repeat_times, name=None):
    """``x`` repeated ``repeat_times`` (an int, a list or a tensor)
    along its trailing axes, as ``jnp.tile``."""
    x, = amp_cast('tile', as_tensor(x))
    return x.tile(shape_of(repeat_times))


def flip(x, axis, name=None):
    x, = amp_cast('flip', as_tensor(x))
    return torch.flip(x, _axes(axis))


def reverse(x, axis, name=None):
    return flip(x, axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    x, = amp_cast('rot90', as_tensor(x))
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    x, = amp_cast('roll', as_tensor(x))
    return torch.roll(x, shifts, axis)


def gather(x, index, axis=0, name=None):
    """Rows ``index`` of ``x`` along ``axis``: the index's shape takes
    the axis's place, so an int index drops the axis, as ``jnp.take``
    does."""
    x, = amp_cast('gather', as_tensor(x))
    axis = int(raw(axis)) % x.dim()
    index = torch.as_tensor(index, device=x.device)
    return torch.index_select(x, axis, index.reshape(-1).long()) \
        .reshape(x.shape[:axis] + tuple(index.shape) + x.shape[axis + 1:])


def _points(index, x):
    return tuple(torch.movedim(as_tensor(index, like=x).long(), -1, 0))


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``."""
    x, = amp_cast('gather_nd', as_tensor(x))
    return x[_points(index, x)]


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with rows ``index`` set to ``updates`` (or, with
    ``overwrite=False``, the updates added into them); ``x`` is left as
    it was."""
    x, updates = amp_cast('scatter', as_tensor(x), as_tensor(updates))
    idx = as_tensor(index, like=x).long()
    return x.index_put((idx,), updates.to(x.dtype),
                       accumulate=not overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    idx = as_tensor(index, like=x).long()
    return x.index_put_((idx,), as_tensor(updates, like=x).to(x.dtype),
                        accumulate=not overwrite)


def scatter_nd_add(x, index, updates, name=None):
    """``x`` with ``updates`` added at the positions ``index[...,
    :k]`` names (repeated positions add up), as the reference's
    ``v.at[...].add(u)``; ``x`` itself is left as it was."""
    x, updates = amp_cast('scatter_nd_add', as_tensor(x),
                          as_tensor(updates))
    return x.index_put(_points(index, x), updates.to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    """Zeros of ``shape`` with ``updates`` added at ``index`` (repeated
    positions add up)."""
    updates, = amp_cast('scatter_nd', as_tensor(updates))
    zeros = torch.zeros(shape_of(shape), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(_points(index, updates), updates,
                           accumulate=True)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype='int64', name=None):
    """The sorted unique values of ``x`` (of its slices along ``axis``),
    with the first index of each, the inverse map and the counts where
    asked for, in that order.  The count is the data's (a read back)."""
    x = as_tensor(x)
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        flat = inverse.reshape(-1)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.long, device=x.device)
        out.append(first.scatter_reduce(
            0, flat, torch.arange(flat.numel(), device=x.device),
            reduce='amin'))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def repeat_interleave(x, repeats, axis=None, name=None):
    x, = amp_cast('repeat_interleave', as_tensor(x))
    return torch.repeat_interleave(x, raw(repeats) if not isinstance(
        repeats, torch.Tensor) or repeats.numel() == 1 else repeats,
        dim=axis)


def _broadcast_index(arr, idx, axis):
    """``arr`` and ``idx`` broadcast against each other on every axis
    but ``axis`` (``jnp.take_along_axis``)."""
    shape = [builtins.max(a, i) for a, i in zip(arr.shape, idx.shape)]
    a_shape, i_shape = list(shape), list(shape)
    a_shape[axis], i_shape[axis] = arr.shape[axis], idx.shape[axis]
    return arr.expand(a_shape), idx.expand(i_shape)


def take_along_axis(arr, indices, axis, broadcast=True):
    arr, = amp_cast('take_along_axis', as_tensor(arr))
    axis = axis % arr.dim()
    a, i = _broadcast_index(arr, as_tensor(indices, like=arr).long(), axis)
    return torch.gather(a, axis, i)


def put_along_axis(arr, indices, values, axis, reduce='assign'):
    """``arr`` with ``values`` (broadcast to the indices) written, or
    with ``reduce='add'`` added, at ``indices`` along ``axis``."""
    arr, = amp_cast('put_along_axis', as_tensor(arr))
    axis = axis % arr.dim()
    idx = as_tensor(indices, like=arr).long()
    src = as_tensor(values, like=arr).to(arr.dtype).expand(idx.shape)
    if reduce == 'add':
        return arr.scatter_add(axis, idx, src)
    return arr.scatter(axis, idx, src)


def numel(x, name=None):
    x = as_tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def cast(x, dtype):
    return as_tensor(x).to(convert_dtype(dtype))


def slice(input, axes, starts, ends):
    """``input[starts:ends]`` on each listed axis (Python's slice
    rules: negative ends count from the end, bounds clip)."""
    x, = amp_cast('slice', as_tensor(input))
    idx = [builtins.slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = builtins.slice(int(raw(s)), int(raw(e)))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """``x[starts:ends:strides]`` on each listed axis; a negative stride
    walks backwards, as Python's slices do."""
    x, = amp_cast('strided_slice', as_tensor(x))
    for a, s, e, st in zip(axes, starts, ends, strides):
        picks = list(range(x.shape[a]))[builtins.slice(
            int(raw(s)), int(raw(e)), int(raw(st)))]
        x = torch.index_select(x, a, torch.tensor(picks, dtype=torch.long,
                                                  device=x.device))
    return x


def as_strided(x, shape, stride, offset=0, name=None):
    raise NotImplementedError(
        'as_strided is not supported, as in the reference: use reshape, '
        'slice or gather')


def tolist(x):
    return as_tensor(x).tolist()


def tensordot(x, y, axes=2, name=None):
    a, b = amp_cast('tensordot', as_tensor(x), as_tensor(y))
    return torch.tensordot(a, b, dims=axes)


def _atleast(fn, name):
    def op(*inputs, name=None):
        outs = [fn(*amp_cast(name, as_tensor(t))) for t in inputs]
        return outs[0] if len(outs) == 1 else outs
    op.__name__ = name
    return op


atleast_1d = _atleast(torch.atleast_1d, 'atleast_1d')
atleast_2d = _atleast(torch.atleast_2d, 'atleast_2d')
atleast_3d = _atleast(torch.atleast_3d, 'atleast_3d')


def crop(x, shape=None, offsets=None, name=None):
    """``x`` cut to ``shape`` from ``offsets``; -1 in ``shape`` keeps
    the rest of that axis."""
    x, = amp_cast('crop', as_tensor(x))
    nd = x.dim()
    offs = [0] * nd if offsets is None else list(shape_of(offsets))
    out = list(x.shape) if shape is None else list(shape_of(shape))
    sizes = [x.shape[d] - offs[d] if out[d] == -1 else out[d]
             for d in range(nd)]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, sizes))]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Label ids of the ``shard_id``-th of ``nshards`` vocab shards as
    local offsets, the others ``ignore_value``."""
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f'shard_id {shard_id} out of range for nshards={nshards}')
    v = as_tensor(input)
    size = (int(index_num) + int(nshards) - 1) // int(nshards)
    in_shard = torch.div(v, size, rounding_mode='floor') == shard_id
    return torch.where(in_shard, v - shard_id * size,
                       torch.full_like(v, ignore_value))


def shape(input, name=None):
    """The shape of ``input`` as a 1-D int32 tensor."""
    x = as_tensor(input)
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def rank(input, name=None):
    """The number of axes as a 0-d int32 tensor."""
    x = as_tensor(input)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def _reshape_in_place(x, new_shape):
    """``x`` given ``new_shape`` in place (a contiguous ``x``)."""
    if not x.is_contiguous():
        raise ValueError('an in-place reshape needs a contiguous tensor')
    shape = torch.empty(x.shape, device='meta').reshape(new_shape).shape
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return x.as_strided_(shape, strides)


def reshape_(x, shape, name=None):
    return _reshape_in_place(x, shape_of(shape))


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _reshape_in_place(x, _flat_shape(x, start_axis, stop_axis))


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    for a in sorted((a % x.dim() for a in _axes(axis)), reverse=True):
        if x.shape[a] == 1:
            x.squeeze_(a)
    return x


def unsqueeze_(x, axis, name=None):
    for a in sorted(int(raw(a)) for a in _axes(axis)):
        x.unsqueeze_(a)
    return x
