"""paddle_tpu_torch.distributed.fleet — the distributed training facade
on one process (counterpart of ``paddle_tpu/distributed/fleet``).

``fleet.init(is_collective=True, strategy=s)``, then
``fleet.distributed_optimizer(opt)`` (the Lamb and DGC swaps, the
strategy carried on the optimizer), then ``ParallelTrainer``, which
honours ``s.amp``, ``s.recompute`` and ``s.gradient_merge``.  The
reference's 25 public names are here; what needs several processes
raises, citing ROADMAP item 9b.
"""
from .distributed_strategy import DistributedStrategy  # noqa: F401
from .fleet_base import (  # noqa: F401
    init, is_first_worker, worker_index, worker_num, is_worker,
    worker_endpoints, server_num, server_index, server_endpoints,
    is_server, barrier_worker, init_worker, init_server, run_server,
    stop_worker, distributed_optimizer, distributed_model,
    get_hybrid_communicate_group, get_fleet, validate_strategy)
from . import meta_parallel  # noqa: F401
from .meta_parallel import (  # noqa: F401
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    ParallelCrossEntropy, PipelineLayer, LayerDesc, get_rng_state_tracker)
from .fleet_base import Fleet, HybridCommunicateGroup  # noqa: F401
from .topology import CommunicateTopology  # noqa: F401
from .role_maker import (  # noqa: F401
    Role, PaddleCloudRoleMaker, UserDefinedRoleMaker, UtilBase)
from .data_generator import (  # noqa: F401
    MultiSlotDataGenerator, MultiSlotStringDataGenerator)
from . import utils  # noqa: F401
from . import metrics  # noqa: F401


def __getattr__(name):
    # fleet.util follows the current Fleet's role maker
    if name == 'util':
        return get_fleet().util
    raise AttributeError(name)


__all__ = ['DistributedStrategy', 'init', 'distributed_optimizer',
           'distributed_model', 'worker_index', 'worker_num',
           'is_first_worker', 'ColumnParallelLinear', 'RowParallelLinear',
           'VocabParallelEmbedding', 'ParallelCrossEntropy',
           'PipelineLayer', 'LayerDesc', 'get_hybrid_communicate_group',
           'Fleet', 'HybridCommunicateGroup', 'CommunicateTopology',
           'Role', 'PaddleCloudRoleMaker', 'UserDefinedRoleMaker',
           'UtilBase', 'MultiSlotDataGenerator',
           'MultiSlotStringDataGenerator', 'utils', 'util']
