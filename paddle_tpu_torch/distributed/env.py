"""Parallel environment state (counterpart of
``paddle_tpu/distributed/env.py``): ``ParallelEnv``, ``get_rank`` and
``get_world_size``.

The rank and the world size come from ``torch.distributed`` once its
process group is initialised, else from the launcher's environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, which
``distributed.launch`` and ``elastic`` set), else rank 0 of a world of
1.  One process drives one card here, where one JAX process drives
every chip of its host: the reference's world size counts the chips of
its mesh, the port's counts processes.  ``build_mesh``/``set_mesh``/
``get_mesh`` come with data and tensor parallelism (ROADMAP item 9b).
"""
import os

__all__ = ['ParallelEnv', 'get_rank', 'get_world_size']

# what anything needing more than one process raises with
ITEM_9B = ('data, tensor, pipeline and sequence parallelism over '
           'torch.distributed are not ported yet (ROADMAP Queue 1 item '
           '9b); the port trains on one process')


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
