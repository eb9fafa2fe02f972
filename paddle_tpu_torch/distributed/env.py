"""Parallel environment state (counterpart of
``paddle_tpu/distributed/env.py``): ``ParallelEnv``, ``get_rank``,
``get_world_size`` and the global mesh (``build_mesh``, ``set_mesh``,
``get_mesh``, ``default_mesh_devices``).

The rank and the world size come from ``torch.distributed`` once its
process group is initialised, else from the launcher's environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, which
``distributed.launch`` and ``elastic`` set), else rank 0 of a world of
1.  One process drives one card here, where one JAX process drives
every chip of its host: the reference's world size counts the chips of
its mesh, the port's counts processes, and a mesh is laid over the
ranks (``np.arange(world).reshape(sizes)``, the last axis innermost, so
a ``tp`` group is a run of consecutive ranks).

A ``Mesh`` names its axes and sizes as the reference's does
(``axis_names``, ``shape``, ``devices`` — here the ranks) and holds the
``torch.distributed.device_mesh.DeviceMesh`` over those ranks once a
process group is up (``device_mesh``; None in a process without one,
where every axis has size 1 and every collective is the identity).
"""
import collections
import os

import numpy as np

__all__ = ['ParallelEnv', 'get_rank', 'get_world_size', 'get_mesh',
           'set_mesh', 'build_mesh', 'default_mesh_devices', 'Mesh']

# what the parts of data and tensor parallelism still to port raise with
ITEM_9B = ('not ported yet (ROADMAP Queue 1 item 9b, second part: host '
           'collectives, the cluster watchdog and chaos seams, '
           'checkpoints at a world above 1, serving under tensor '
           'parallelism, DGC over tensor-parallel shards)')
ITEM_9C = ('sequence and expert parallelism are not ported yet (ROADMAP '
           'Queue 1 item 9c)')
ITEM_9D = ('pipeline parallelism, ZeRO sharding over dp and quantized '
           'collectives are not ported yet (ROADMAP Queue 1 item 9d)')


def _dist():
    """``torch.distributed`` when its default process group is up, else
    None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _env_int(name, default):
    value = os.environ.get(name, '')
    return int(value) if value.strip() else default


def get_rank():
    """This process's rank: ``torch.distributed``'s, else
    ``PADDLE_TRAINER_ID``, else 0."""
    dist = _dist()
    if dist is not None:
        return dist.get_rank()
    return _env_int('PADDLE_TRAINER_ID', 0)


def get_world_size():
    """The number of processes: ``torch.distributed``'s world size,
    else ``PADDLE_TRAINERS_NUM``, else 1."""
    dist = _dist()
    if dist is not None:
        return dist.get_world_size()
    return _env_int('PADDLE_TRAINERS_NUM', 1)


class Mesh:
    """Named axes over the ranks of the process group (module
    docstring).  ``shape`` maps each axis to its size, in order;
    ``devices`` is the rank grid; ``coords`` this rank's coordinate
    along each axis."""

    def __init__(self, names, sizes, device_type=None):
        self.axis_names = tuple(names)
        self.mesh_dim_names = self.axis_names
        sizes = tuple(int(s) for s in sizes)
        self.shape = collections.OrderedDict(zip(self.axis_names, sizes))
        self.devices = np.arange(int(np.prod(sizes))).reshape(sizes)
        self.size = int(self.devices.size)
        dist = _dist()
        self.rank = dist.get_rank() if dist is not None else 0
        self.coords = dict(zip(
            self.axis_names,
            (int(c) for c in np.argwhere(self.devices == self.rank)[0])))
        self.device_mesh = None
        if dist is not None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            if device_type is None:
                device_type = 'cuda' if dist.get_backend() == 'nccl' \
                    else 'cpu'
            self.device_mesh = DeviceMesh(
                device_type, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        self._groups = {}

    def axis_size(self, name):
        return self.shape.get(name, 1)

    def group(self, axes):
        """The ``collective.Group`` of this rank along ``axes`` (a name
        or a tuple of names), made once per mesh."""
        from . import collective
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        g = self._groups.get(axes)
        if g is None:
            g = self._groups[axes] = collective._mesh_group(self, axes)
        return g

    def __repr__(self):
        return f'Mesh({dict(self.shape)})'


_global_mesh = None


def set_mesh(mesh):
    """Install ``mesh`` as the global mesh (None clears it); the
    ``split`` layer cache keeps only this mesh's entries."""
    global _global_mesh
    if mesh is not _global_mesh:
        from . import mp_ops
        for k in [k for k in mp_ops._LAYER_CACHE if k[-1] is not mesh]:
            del mp_ops._LAYER_CACHE[k]
    _global_mesh = mesh


def get_mesh():
    return _global_mesh


def default_mesh_devices():
    """The ranks a mesh lays out: ``range(world)``."""
    return list(range(get_world_size()))


def build_mesh(axes, device_type=None):
    """``axes``: an ordered dict or list of ``(name, size)``; a size of
    -1 takes what the others leave of the world.  Returns a ``Mesh`` over
    the ranks (the last axis innermost); raises where the axes need more
    ranks than the world has, or, with a process group up, fewer.  With a
    process group up every rank must call it, in the same order (it makes
    the groups of the ``DeviceMesh``)."""
    items = list(axes.items()) if isinstance(axes, dict) else list(axes)
    n = get_world_size()
    sizes = [int(s) for _, s in items]
    known = int(np.prod([s for s in sizes if s > 0])) or 1
    sizes = [s if s > 0 else n // known for s in sizes]
    need = int(np.prod(sizes))
    if need > n:
        raise ValueError(f'mesh axes {items} need {need} > {n} devices')
    if need != n and _dist() is not None:
        raise ValueError(f'mesh axes {items} cover {need} of the {n} '
                         'ranks: a mesh spans the whole process group')
    return Mesh([name for name, _ in items], sizes, device_type)


class ParallelEnv:
    """The reference's ``paddle.distributed.ParallelEnv``; ``dev_id`` is
    this process's card (``FLAGS_selected_gpus``, else the rank)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _env_int('PADDLE_RANK_IN_NODE', get_rank())

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        return _env_int('FLAGS_selected_gpus', self.local_rank)

    @property
    def device_type(self):
        return 'gpu'

    @property
    def current_endpoint(self):
        return os.environ.get('PADDLE_CURRENT_ENDPOINT', '127.0.0.1:0')

    @property
    def trainer_endpoints(self):
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        return eps.split(',') if eps else ['127.0.0.1:0']
