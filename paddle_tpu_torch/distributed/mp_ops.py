"""``paddle.distributed.split`` (counterpart of
``paddle_tpu/distributed/mp_ops.py``): a linear or embedding op whose
weight is split over the mesh's ``tp`` axis, built as one of
``fleet.meta_parallel``'s layers (parallel embedding, row-parallel
linear for ``axis=0``, column-parallel for ``axis=1``).

As in the reference: with ``name=`` (and no ``weight_attr``) the layer
is cached by its name, spec, the global seed and the mesh, so an eager
loop trains one weight; without it each call builds fresh weights, with
a warning once.  ``set_mesh`` drops the entries of other meshes.
"""
import warnings

from . import env as _env

__all__ = ['split']

_LAYER_CACHE = {}
_WARNED_UNNAMED = [False]


def _build(operation, size, axis, gather_out, weight_attr, bias_attr,
           name):
    from .fleet.meta_parallel import (ColumnParallelLinear,
                                      RowParallelLinear,
                                      VocabParallelEmbedding)
    if operation == 'embedding':
        num_emb, dim = size
        return VocabParallelEmbedding(num_emb, dim, weight_attr=weight_attr,
                                      name=name)
    if operation != 'linear':
        raise ValueError("operation must be 'linear' or 'embedding', "
                         f'got {operation!r}')
    in_f, out_f = size
    if axis == 0:
        return RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                 has_bias=bias_attr is not False,
                                 input_is_parallel=False, name=name)
    if axis == 1:
        return ColumnParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                    has_bias=bias_attr is not False,
                                    gather_output=gather_out, name=name)
    raise ValueError(f'axis must be 0 or 1, got {axis}')


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    mesh = _env.get_mesh()
    tp = mesh.axis_size('tp') if mesh is not None else 1
    if num_partitions not in (1, tp):
        warnings.warn(
            f'distributed.split: num_partitions={num_partitions} does not '
            f'match the mesh tp axis ({tp}); the sharding follows the '
            'mesh', stacklevel=2)
    if name is not None and weight_attr is None:
        from ..core import rng as _rng
        key = (name, operation, tuple(size), axis, num_partitions,
               gather_out, bias_attr is not False, _rng.get_seed(), mesh)
        layer = _LAYER_CACHE.get(key)
        if layer is None:
            layer = _LAYER_CACHE[key] = _build(
                operation, size, axis, gather_out, weight_attr, bias_attr,
                name)
        return layer(x)
    if not _WARNED_UNNAMED[0]:
        _WARNED_UNNAMED[0] = True
        why = ('without name=' if name is None
               else 'with a custom weight_attr (no value-based cache '
                    'identity)')
        warnings.warn(
            f'distributed.split {why} creates FRESH weights on every '
            'eager call (reference dygraph semantics) — pass name= '
            'without weight_attr to reuse one layer across steps, or '
            'use the fleet.meta_parallel layer classes directly',
            stacklevel=2)
    return _build(operation, size, axis, gather_out, weight_attr,
                  bias_attr, name)(x)
