"""Training step of the port (counterpart of ``paddle_tpu/parallel``):
``ParallelTrainer`` over one card or a data- and tensor-parallel world,
and the sharding annotations of ``api``."""
from . import api  # noqa: F401
from .api import (  # noqa: F401
    collect_param_shardings, make_spec, maybe_shard, named_sharding)
from .engine import ParallelTrainer

__all__ = ['ParallelTrainer', 'api', 'maybe_shard',
           'collect_param_shardings', 'named_sharding', 'make_spec']
