"""Collective communication over ``torch.distributed`` (counterpart of
the device half of ``paddle_tpu/distributed/collective.py``).

The reference's collectives are trace-time XLA ops over the mesh axes
of a ``shard_map`` region, where each device holds a shard.  The port
is multi-controller: one process a card, and a rank's tensor plays the
part of its shard.  Each collective here is a call into
``torch.distributed`` over a ``Group``, with the reference's result on
every rank; a process without a process group is a world of one, where
each is the identity, as the reference's are outside a region.

A ``Group`` is the reference's: an id and the mesh axes it spans
(``new_group(axes=('dp',))``), or a list of ranks; it holds the ranks
in group order (``ranks``), this rank's index in it (``rank``), and the
``torch.distributed`` process group (``process_group``; None for a
group of one, whose collectives are local).  ``src``/``dst`` arguments
are indices in the group, as the reference's are axis indices.

``axis_scope``/``current_axes`` name the mesh axes a training step runs
over (the trainer and ``DataParallel`` enter them), and read where a
reduction must span the global batch: ``BatchNorm``'s statistics,
BERT's masked mean.  ``get_axis_rank`` is this rank's coordinate on the
global mesh (the reference answers 0 outside a region).

gloo has no CUDA path for most collectives: on a gloo group a CUDA
tensor is staged through pinned host memory (``staged_through_host``
says whether a group does); NCCL groups never stage.  A staged
collective cannot run inside a CUDA graph capture, and raises there.

The host transport (``HostCollectives``, ``FileKVStore``, the ledger,
``CollectiveTimeout``) is ROADMAP item 9b's second part.
"""
import contextlib
import datetime
import os

import numpy as np
import torch

from . import env as _env

__all__ = ['ReduceOp', 'Group', 'new_group', 'get_group', 'all_reduce',
           'all_gather', 'all_gather_object', 'broadcast', 'reduce',
           'scatter', 'alltoall', 'send', 'recv', 'p2p', 'p2p_rotate',
           'barrier', 'wait', 'axis_scope', 'current_axes',
           'get_axis_rank', 'split_group', 'staged_through_host',
           'HostCollectives']


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _torch_op(op):
    dist = torch.distributed
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.AVG: dist.ReduceOp.SUM}[op]


class Group:
    """A communicator: the mesh axes it spans (or its rank list), its
    ranks in group order, and the ``torch.distributed`` group."""

    def __init__(self, id, axes, ranks=None, process_group=None):
        self.id = id
        self.axes = tuple(axes)
        self.ranks = list(ranks) if ranks is not None else [0]
        self.nranks = len(self.ranks)
        me = _env.get_rank() if _env._dist() is not None else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.process_group = process_group

    @property
    def name(self):
        return f"group_{self.id}:{','.join(self.axes)}"

    def __repr__(self):
        return f'Group(id={self.id}, axes={self.axes}, ranks={self.ranks})'


_groups = {}
_next_gid = 1


def _world_group():
    dist = _env._dist()
    if dist is None:
        return Group(0, (), [0])
    mesh = _env.get_mesh()
    axes = tuple(mesh.axis_names) if mesh is not None else ()
    return Group(0, axes, range(dist.get_world_size()), dist.group.WORLD)


def _timeout():
    return datetime.timedelta(
        seconds=float(os.environ.get('PADDLE_DIST_TIMEOUT', '600')))


def _comm_lists(mesh, axes):
    """Every group of ranks that talk along ``axes``: one a combination
    of the other axes' coordinates, each in row-major order of
    ``axes``."""
    names = list(mesh.axis_names)
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in idx]
    grid = mesh.devices.transpose(rest + idx)
    n = int(np.prod([mesh.devices.shape[i] for i in idx]))
    return [[int(r) for r in row] for row in grid.reshape(-1, n)]


def _mesh_group(mesh, axes):
    """The group of this rank along ``axes`` of ``mesh``: the
    ``DeviceMesh``'s group for one axis, else new groups over every
    partition (each rank makes them all, in order)."""
    global _next_gid
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f'axis {a!r} is not on the mesh {mesh}')
    mine = next(g for g in _comm_lists(mesh, axes) if mesh.rank in g)
    pg = None
    if mesh.device_mesh is not None:
        if len(mine) == mesh.size:
            pg = torch.distributed.group.WORLD
        elif len(mine) == 1:
            pass
        elif len(axes) == 1:
            pg = mesh.device_mesh.get_group(axes[0])
        else:
            for ranks in _comm_lists(mesh, axes):
                made = torch.distributed.new_group(ranks, timeout=_timeout())
                if mesh.rank in ranks:
                    pg = made
    gid = _next_gid
    _next_gid += 1
    g = Group(gid, axes, mine, pg)
    _groups[gid] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _world_group()
    return _groups[gid]


def new_group(ranks=None, backend=None, axes=None):
    """A group along mesh ``axes`` (of the global mesh), or over the
    global ``ranks``; with a process group up every rank must call it,
    in the same order.  Neither: the world's axes."""
    global _next_gid
    mesh = _env.get_mesh()
    if axes is not None and mesh is not None:
        return mesh.group(tuple(axes))
    dist = _env._dist()
    if ranks is None or dist is None:
        g = _world_group()
        g.id, _next_gid = _next_gid, _next_gid + 1
        if axes is not None:
            g.axes = tuple(axes)
        _groups[g.id] = g
        return g
    ranks = [int(r) for r in ranks]
    pg = dist.new_group(ranks, backend=backend, timeout=_timeout()) \
        if len(ranks) > 1 else None
    gid = _next_gid
    _next_gid += 1
    g = Group(gid, axes or (), ranks, pg)
    _groups[gid] = g
    return g


def split_group(mesh_axis):
    """The group of one mesh axis."""
    return new_group(axes=(mesh_axis,))


# -- axis scope: the mesh axes a step runs over --------------------------------

_axis_stack = []


@contextlib.contextmanager
def axis_scope(*names):
    """Entered by the trainer and ``DataParallel`` around a step, so the
    reductions that must span the global batch know its axes."""
    _axis_stack.append(tuple(names))
    try:
        yield
    finally:
        _axis_stack.pop()


def current_axes():
    return _axis_stack[-1] if _axis_stack else ()


def get_axis_rank(axis):
    """This rank's coordinate along ``axis`` of the global mesh (0
    without one, or off it)."""
    mesh = _env.get_mesh()
    if mesh is None or axis not in mesh.shape:
        return 0
    return mesh.coords[axis]


def scope_group(axis):
    """The group of ``axis`` while a step runs over it with more than
    one rank on it, else None (the reduction stays local)."""
    mesh = _env.get_mesh()
    if mesh is None or axis not in current_axes() or \
            mesh.axis_size(axis) <= 1:
        return None
    return mesh.group(axis)


# -- the transport -----------------------------------------------------------

def _group(group):
    if group is None or group == 0:
        return _world_group()
    if isinstance(group, Group):
        return group
    if isinstance(group, (tuple, list, str)):
        return new_group(axes=(group,) if isinstance(group, str)
                         else tuple(group))
    raise TypeError(f'not a group: {group!r}')


def staged_through_host(group=None, tensor=None):
    """Whether a collective of ``group`` on ``tensor`` goes through
    pinned host memory: a CUDA tensor on a gloo group."""
    g = _group(group)
    if g.process_group is None:
        return False
    backend = torch.distributed.get_backend(g.process_group)
    return backend == 'gloo' and (tensor is None or tensor.is_cuda)


def _staged(g, tensor):
    """Whether a collective on ``g`` takes ``tensor`` through host
    memory (a gloo group, a tensor on the card); raises under a CUDA
    graph capture, which cannot hold that copy."""
    if not (tensor.is_cuda and staged_through_host(g)):
        return False
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            'a collective on a gloo group goes through host memory and '
            'cannot be captured in a CUDA graph: use NCCL for '
            'step_fused, or train eagerly')
    return True


def _run(g, tensor, fn):
    """``fn(t)`` on ``tensor`` (in place), or on a pinned host copy
    copied back where ``g`` is a gloo group and the tensor is on the
    card."""
    if not _staged(g, tensor):
        fn(tensor)
        return tensor
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    fn(host)
    tensor.copy_(host)
    return tensor


def _local(g):
    """A group with nothing to talk to: no process group (a process
    outside a world, or an axis of size 1)."""
    return g.process_group is None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    g = _group(group)
    if _local(g):
        return tensor

    def fn(t):
        torch.distributed.all_reduce(t, op=_torch_op(op),
                                     group=g.process_group)
        if op == ReduceOp.AVG:
            t.div_(g.nranks)
    return _run(g, tensor, fn)


def _gather(g, tensor):
    """Every rank's ``tensor``, in group order."""
    if _local(g):
        return [tensor]
    src = tensor.contiguous()
    if _staged(g, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(g.nranks)]
    torch.distributed.all_gather(parts, src, group=g.process_group)
    return [p.to(tensor.device) for p in parts]


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """``tensor_list`` (out) gets every rank's tensor in group order;
    returns them concatenated along ``axis``."""
    parts = _gather(_group(group), tensor)
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
    return torch.cat(parts, dim=axis)


def all_gather_object(obj_list, obj, group=None):
    """Every rank's picklable ``obj``, appended to ``obj_list`` in group
    order."""
    g = _group(group)
    if _local(g):
        obj_list.append(obj)
        return obj_list
    out = [None] * g.nranks
    torch.distributed.all_gather_object(out, obj, group=g.process_group)
    obj_list.extend(out)
    return obj_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """The group's rank ``src``'s tensor on every rank, in place."""
    g = _group(group)
    if _local(g):
        return tensor
    return _run(g, tensor, lambda t: torch.distributed.broadcast(
        t, src=g.ranks[src], group=g.process_group))


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on the group's rank ``dst``; the others keep
    their tensor (the reference's result)."""
    g = _group(group)
    if _local(g):
        return tensor
    out = all_reduce(tensor.clone(), op, g)
    if g.rank == dst:
        tensor.copy_(out)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` gets entry ``rank`` of the group's rank ``src``'s
    ``tensor_list``."""
    g = _group(group)
    if _local(g):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    if g.rank == src:
        stacked = torch.stack([torch.as_tensor(t) for t in tensor_list])
    else:
        stacked = torch.empty((g.nranks,) + tuple(tensor.shape),
                              dtype=tensor.dtype, device=tensor.device)
    broadcast(stacked, src, g)
    tensor.copy_(stacked[g.rank])
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Entry ``j`` of rank ``i``'s list lands at entry ``i`` of rank
    ``j``'s: returns (and extends ``out_tensor_list`` with) the
    entries this rank receives."""
    g = _group(group)
    stacked = torch.stack([torch.as_tensor(t) for t in in_tensor_list])
    if _local(g):
        outs = list(stacked.unbind(0))
    else:
        outs = [part[g.rank] for part in _gather(g, stacked)]
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
    return outs


def p2p(tensor, src, dst, group=None):
    """One matched send/recv pair: the group's rank ``dst`` receives
    rank ``src``'s tensor, every other rank zeros (in place)."""
    g = _group(group)
    if _local(g):
        return tensor
    if src == dst:
        if g.rank != dst:
            tensor.zero_()
        return tensor
    pg = g.process_group
    if g.rank == src:
        _run(g, tensor.clone(), lambda t: torch.distributed.send(
            t, g.ranks[dst], group=pg))
        tensor.zero_()
    elif g.rank == dst:
        _run(g, tensor, lambda t: torch.distributed.recv(
            t, g.ranks[src], group=pg))
    else:
        tensor.zero_()
    return tensor


def send(tensor, dst=0, group=None, sync_op=True, src=None):
    """``p2p(src -> dst)``: every rank runs the line, so the sender is
    explicit (the reference's SPMD contract)."""
    g = _group(group)
    if _local(g):
        return tensor
    if src is None:
        raise ValueError(
            'send() needs src= (every rank runs this line); use '
            'p2p(tensor, src, dst) or p2p_rotate()')
    return p2p(tensor, src, dst, g)


def recv(tensor, src=0, group=None, sync_op=True, dst=None):
    """Pairs with ``send``: with ``dst``, ``p2p(src -> dst)``; without,
    every rank receives ``src``'s tensor (a broadcast)."""
    g = _group(group)
    if _local(g):
        return tensor
    if dst is not None:
        return p2p(tensor, src, dst, g)
    return broadcast(tensor, src, g)


def p2p_rotate(tensor, group=None, shift=1):
    """Ring rotation: the group's rank ``i`` sends to ``(i + shift) %
    n``; returns what this rank received, in place."""
    g = _group(group)
    if _local(g):
        return tensor
    n, me = g.nranks, g.rank
    to, frm = g.ranks[(me + shift) % n], g.ranks[(me - shift) % n]
    if to == g.ranks[me]:
        return tensor

    def fn(t):
        out = t.clone()
        ops = [torch.distributed.P2POp(torch.distributed.isend, out, to,
                                       g.process_group),
               torch.distributed.P2POp(torch.distributed.irecv, t, frm,
                                       g.process_group)]
        for req in torch.distributed.batch_isend_irecv(ops):
            req.wait()
    return _run(g, tensor, fn)


def barrier(group=None):
    """Wait for every rank of the group."""
    g = _group(group)
    if _local(g):
        return
    torch.distributed.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until ``tensor``'s pending work is done."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class HostCollectives:
    """The reference's host transport: ROADMAP item 9b's second
    part."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'HostCollectives: {_env.ITEM_9B}')
