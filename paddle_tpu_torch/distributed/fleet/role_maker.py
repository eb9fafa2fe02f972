"""Role makers and ``fleet.util`` (counterpart of
``paddle_tpu/distributed/fleet/role_maker.py``): ``Role``,
``PaddleCloudRoleMaker`` (the launch environment),
``UserDefinedRoleMaker`` (an explicit topology) and ``UtilBase``, the
host-side helpers.

Workers are processes; there are no parameter-server processes, so the
server roles report none unless configured.  ``UtilBase``'s
``all_reduce``, ``all_gather`` and ``barrier`` act on host values over
the process group's world (``torch.distributed``'s object gather, the
reduction in numpy), and on one process they are the value itself and
no wait, as the reference's are there.  A role maker that counts
several workers with no process group up raises.
"""
import os

import numpy as np
import torch

from .. import env as _env

__all__ = ['Role', 'PaddleCloudRoleMaker', 'UserDefinedRoleMaker',
           'UtilBase']


class Role:
    WORKER = 1
    SERVER = 2


class _RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role = Role.WORKER
        self._current_id = 0

    def _worker_index(self):
        return _env.get_rank()

    def _worker_num(self):
        return _env.get_world_size()

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _is_first_worker(self):
        return self._is_worker() and self._worker_index() == 0

    def _get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def _get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def _server_num(self):
        return len(self._server_endpoints)


class PaddleCloudRoleMaker(_RoleMakerBase):
    """The launch environment: the rank and world size of
    ``distributed.env``, and ``PADDLE_TRAINER_ENDPOINTS`` /
    ``PADDLE_PSERVERS_IP_PORT_LIST`` when set."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        self._worker_endpoints = [e for e in eps.split(',') if e]
        seps = os.environ.get('PADDLE_PSERVERS_IP_PORT_LIST', '')
        self._server_endpoints = [e for e in seps.split(',') if e]


class UserDefinedRoleMaker(_RoleMakerBase):
    """An explicit topology."""

    def __init__(self, is_collective=False, init_gloo=False,
                 current_id=0, role=Role.WORKER, worker_num=1,
                 worker_endpoints=None, server_endpoints=None, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = list(worker_endpoints or [])
        self._server_endpoints = list(server_endpoints or [])
        self._user_worker_num = worker_num

    def _worker_index(self):
        return self._current_id

    def _worker_num(self):
        return self._user_worker_num


class UtilBase:
    """``fleet.util``: host-side helpers outside the training step —
    a reduce of host values over the workers, a barrier, and the
    sharding of an input file list."""

    def __init__(self, role_maker=None):
        self._role_maker = role_maker

    def _pcount(self):
        if self._role_maker is not None:
            return self._role_maker._worker_num()
        return _env.get_world_size()

    def _pindex(self):
        if self._role_maker is not None:
            return self._role_maker._worker_index()
        return _env.get_rank()

    def _world(self, what):
        """Whether the workers span a process group (False: one
        worker)."""
        n = self._pcount()
        if n == 1:
            return False
        if _env._dist() is None or _env.get_world_size() != n:
            raise RuntimeError(
                f'fleet.util.{what} over {n} workers needs their process '
                'group: call fleet.init or distributed.init_parallel_env '
                'in every worker first')
        return True

    def all_gather(self, input, comm_world='worker'):
        """Every worker's ``input``, in rank order."""
        if not self._world('all_gather'):
            return [input]
        out = [None] * self._pcount()
        torch.distributed.all_gather_object(out, input)
        return out

    def all_reduce(self, input, mode='sum', comm_world='worker'):
        """The elementwise ``mode`` (sum, max, min) of ``input`` over the
        workers, as a numpy array."""
        if mode not in ('sum', 'max', 'min'):
            raise ValueError(f"mode must be 'sum', 'max' or 'min', got "
                             f'{mode!r}')
        parts = [np.asarray(v) for v in self.all_gather(np.asarray(input),
                                                        comm_world)]
        return getattr(np, mode)(np.stack(parts), axis=0)

    def barrier(self, comm_world='worker'):
        if self._world('barrier'):
            torch.distributed.barrier()

    def get_file_shard(self, files):
        """``files`` split evenly over the workers, the earlier workers
        taking the remainder (the reference's contract)."""
        if not isinstance(files, list):
            raise TypeError('files should be a list of file paths')
        n, i = self._pcount(), self._pindex()
        base, rem = divmod(len(files), n)
        begin = i * base + min(i, rem)
        return files[begin: begin + base + (1 if i < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        if self._pindex() == rank_id:
            print(message, flush=True)
