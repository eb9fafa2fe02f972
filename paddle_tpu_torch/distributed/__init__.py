"""Distributed layers of the port: the parallel environment and the
mesh (``env``), the collectives over ``torch.distributed``
(``collective``), ``init_parallel_env`` and ``DataParallel``, ``split``
(``mp_ops``), ``fleet`` (the strategy, the optimizer swaps, the hybrid
groups, the tensor-parallel layers, the role and topology API),
``checkpoint`` (async, verified commits), ``elastic`` (supervised
workers), ``launch`` (one worker a card) and ``utils`` (the cluster and
the local trainers).  The host transport, checkpoints at a world above
1 and serving under tensor parallelism are ROADMAP item 9b's second
part; sequence and expert parallelism item 9c; pipeline, ZeRO and the
rest item 9d."""
from . import env  # noqa: F401
from .env import (  # noqa: F401
    ParallelEnv, build_mesh, get_mesh, get_rank, get_world_size, set_mesh)
from . import collective  # noqa: F401
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    axis_scope, barrier, broadcast, current_axes, get_group, new_group,
    p2p_rotate, recv, reduce, scatter, send, wait)
from .parallel import DataParallel, init_parallel_env  # noqa: F401
from . import fleet  # noqa: F401
from .mp_ops import split  # noqa: F401
from . import checkpoint, elastic, launch, utils  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointManager, load_sharded, save_sharded)

__all__ = ['ParallelEnv', 'get_rank', 'get_world_size', 'get_mesh',
           'set_mesh', 'build_mesh', 'ReduceOp', 'new_group', 'get_group',
           'all_reduce', 'all_gather', 'broadcast', 'reduce', 'scatter',
           'alltoall', 'send', 'recv', 'barrier', 'wait',
           'init_parallel_env', 'DataParallel', 'fleet', 'launch',
           'save_sharded', 'load_sharded', 'CheckpointManager', 'split',
           'checkpoint', 'elastic', 'collective', 'utils']
