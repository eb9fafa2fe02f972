"""fleet.utils (counterpart of ``paddle_tpu/distributed/fleet/utils``):
the filesystem clients, the parameter-server inference shim and
``recompute``."""
from .fs import HDFSClient, LocalFS  # noqa: F401
from .ps_util import DistributedInfer  # noqa: F401
from .recompute import recompute  # noqa: F401

__all__ = ['LocalFS', 'HDFSClient', 'recompute', 'DistributedInfer']
