"""Fleet of the port: the single-device tensor-parallel layers and the
training strategy object."""
from . import meta_parallel
from .distributed_strategy import DistributedStrategy

__all__ = ['meta_parallel', 'DistributedStrategy']
