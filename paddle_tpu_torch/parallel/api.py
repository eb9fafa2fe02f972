"""Sharding annotations (counterpart of ``paddle_tpu/parallel/api.py``).

Layers declare a spec per parameter in ``_param_shardings``: a tuple of
mesh-axis names (None a replicated dim, ``'...'`` leading dims
replicated).  The reference turns them into ``NamedSharding``s that XLA
partitions by; the port's layers already hold their shards
(``fleet.meta_parallel``), so the specs here drive ``convert.
shard_state``/``gather_state`` and the checks, and ``maybe_shard`` is
the identity.  Axes absent from the mesh, or of size 1, drop to
replication, as in the reference.
"""
import collections

from ..distributed import env as _env

__all__ = ['maybe_shard', 'collect_param_shardings', 'named_sharding',
           'make_spec', 'PartitionSpec', 'NamedSharding']


class PartitionSpec(tuple):
    """A tuple of mesh-axis names (or None), one per dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f'PartitionSpec{tuple(self)!r}'


NamedSharding = collections.namedtuple('NamedSharding', ['mesh', 'spec'])


def make_spec(spec, ndim, mesh=None):
    """A layer's spec tuple as a ``PartitionSpec`` of ``ndim`` dims,
    the axes the mesh lacks (or has at size 1) dropped."""
    mesh = mesh or _env.get_mesh()
    if spec is None:
        return PartitionSpec()
    names = set(mesh.axis_names) if mesh is not None else set()
    if spec and spec[0] == '...':
        tail = list(spec[1:])
        parts = [None] * (ndim - len(tail)) + tail
    else:
        parts = list(spec) + [None] * (ndim - len(spec))
    return PartitionSpec(*[
        p if p is None or (p in names and mesh.axis_size(p) > 1) else None
        for p in parts])


def named_sharding(spec, ndim, mesh=None):
    """``(mesh, make_spec(...))``, or None without a mesh."""
    mesh = mesh or _env.get_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, make_spec(spec, ndim, mesh))


def maybe_shard(x, spec):
    """The identity: the port's layouts are explicit."""
    return x


def collect_param_shardings(layer):
    """``{qualified parameter name: spec tuple}`` from each sublayer's
    ``_param_shardings`` (None where it gives none)."""
    out = {}
    for prefix, mod in layer.named_modules():
        specs = getattr(mod, '_param_shardings', {}) or {}
        for name, p in mod.named_parameters(recurse=False):
            out[f'{prefix}.{name}' if prefix else name] = specs.get(name)
    return out
