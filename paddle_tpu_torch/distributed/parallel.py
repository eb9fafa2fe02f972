"""``init_parallel_env`` and ``DataParallel`` over ``torch.distributed``
(counterpart of ``paddle_tpu/distributed/parallel.py``).

``init_parallel_env(n_devices, axes)`` brings the process group up
where the launcher asked for one (``PADDLE_TRAINERS_NUM`` above 1,
``PADDLE_DIST_INIT_METHOD``, or ``MASTER_ADDR``/``MASTER_PORT``, which
``distributed.launch`` sets): NCCL for a process with a card, gloo
without, or ``PADDLE_DISTRI_BACKEND`` where the caller sets it; the
rendezvous is ``PADDLE_DIST_INIT_METHOD`` (``file://`` or ``tcp://``)
or ``env://``, with ``PADDLE_DIST_TIMEOUT`` seconds (600) for every
collective.  It then installs the global mesh, ``{'dp': world}`` by
default (``axes`` as the reference's), and returns a ``ParallelEnv``.

``DataParallel`` wraps a layer for an eager loop over the mesh's ``dp``
group (or ``group``): it broadcasts the parameters and buffers from the
group's rank 0 when it wraps, its forward runs under
``collective.axis_scope('dp')`` (so ``BatchNorm`` takes statistics over
the group), ``scale_loss`` divides by the group's size and
``apply_collective_grads`` sums the gradients over the group in flat
buckets (``allreduce_gradients``).  On one rank all of it is the
identity, as the reference's is outside a parallel region.
"""
import os

import torch

from . import collective
from . import env as _env

__all__ = ['init_parallel_env', 'DataParallel', 'allreduce_gradients']

# elements a bucket of the gradient all-reduce holds at most
BUCKET_NUMEL = 1 << 26


def _backend():
    named = os.environ.get('PADDLE_DISTRI_BACKEND', '').strip()
    if named:
        return named
    return 'nccl' if torch.cuda.is_available() else 'gloo'


def ensure_process_group():
    """Bring the default process group up from the launcher's
    environment (module docstring) where one is asked for and none is
    up; returns whether one is up."""
    import datetime
    dist = torch.distributed
    if dist.is_initialized():
        return True
    world = _env._env_int('PADDLE_TRAINERS_NUM', 1)
    method = os.environ.get('PADDLE_DIST_INIT_METHOD', '').strip()
    if world <= 1 and not method and 'MASTER_ADDR' not in os.environ:
        return False
    backend = _backend()
    if backend == 'nccl':
        torch.cuda.set_device(_env.ParallelEnv().dev_id
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=method or 'env://',
        rank=_env._env_int('PADDLE_TRAINER_ID', 0), world_size=world,
        timeout=datetime.timedelta(seconds=float(
            os.environ.get('PADDLE_DIST_TIMEOUT', '600'))))
    return True


def init_parallel_env(n_devices=None, axes=None):
    """The process group (where one is asked for) and the global mesh:
    ``axes`` (e.g. ``{'dp': 2, 'tp': 2}``), or ``{'dp': n_devices or
    world}``; an installed mesh stays when neither is given."""
    ensure_process_group()
    if _env.get_mesh() is not None and n_devices is None and axes is None:
        return _env.ParallelEnv()
    if axes is None:
        axes = {'dp': n_devices or _env.get_world_size()}
    _env.set_mesh(_env.build_mesh(axes))
    return _env.ParallelEnv()


def _buckets(tensors):
    """The tensors grouped by dtype and device, each group cut into
    buckets of at most ``BUCKET_NUMEL`` elements."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        bucket, size = [], 0
        for t in ts:
            if bucket and size + t.numel() > BUCKET_NUMEL:
                yield bucket
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel()
        if bucket:
            yield bucket


def allreduce_gradients(params, group, scale=None):
    """Sum the parameters' ``.grad`` over ``group`` in flat buckets, in
    place, times ``scale`` where given (a mean takes ``1 / n``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if collective._local(group) or not grads:
        if scale is not None:
            for g in grads:
                g.mul_(scale)
        return
    with torch.no_grad():
        for bucket in _buckets(grads):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            collective.all_reduce(flat, group=group)
            if scale is not None:
                flat.mul_(scale)
            off = 0
            for g in bucket:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def _dp_group(group):
    if group is not None:
        return collective._group(group)
    mesh = _env.get_mesh()
    if mesh is not None and 'dp' in mesh.shape:
        return mesh.group('dp')
    return collective.get_group(0)


class DataParallel(torch.nn.Module):
    """The reference's ``DataParallel`` (module docstring)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = _dp_group(group)
        self.find_unused_parameters = find_unused_parameters
        if not collective._local(self.group):
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    collective.broadcast(t.data, 0, self.group)

    def forward(self, *inputs, **kwargs):
        with collective.axis_scope('dp'):
            return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """``loss / n`` over the group's ``n`` ranks (the loss as it is
        on one)."""
        n = self.group.nranks
        return loss if n == 1 else loss / n

    def apply_collective_grads(self):
        """Sum the gradients over the group (each rank scaled its loss
        by ``1 / n``, so the sum is the mean)."""
        allreduce_gradients(self._layers.parameters(), self.group)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def named_parameters(self, prefix='', recurse=True,
                         remove_duplicate=True):
        """The wrapped layer's names, unprefixed (``parameters()`` reads
        these too)."""
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)
