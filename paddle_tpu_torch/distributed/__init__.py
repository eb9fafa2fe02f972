"""Distributed layers of the port: the parallel environment
(``ParallelEnv``, ``get_rank``, ``get_world_size``), ``init_parallel_env``
and ``DataParallel`` at one process, ``fleet`` (the strategy, the
optimizer swaps, the role and topology API, ``fleet.utils.recompute``),
``checkpoint`` (async, verified commits), ``elastic`` (supervised
workers) and ``launch`` (the entry point).  Data and tensor parallelism
over ``torch.distributed`` come next (ROADMAP Queue 1 item 9b)."""
from . import env  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .parallel import DataParallel, init_parallel_env  # noqa: F401
from . import fleet  # noqa: F401
from . import checkpoint, elastic, launch  # noqa: F401
from .checkpoint import (  # noqa: F401
    CheckpointManager, load_sharded, save_sharded)

__all__ = ['ParallelEnv', 'get_rank', 'get_world_size',
           'init_parallel_env', 'DataParallel', 'fleet', 'checkpoint',
           'elastic', 'launch', 'save_sharded', 'load_sharded',
           'CheckpointManager']
