"""``init_parallel_env`` and ``DataParallel`` at a world size of 1
(counterpart of ``paddle_tpu/distributed/parallel.py``).

On one process ``DataParallel`` is transparent, as the reference's is
outside a parallel region: the forward passes through, ``scale_loss``
and ``apply_collective_grads`` are identities, and the state calls go
to the wrapped layer.  Anything that asks for more than one rank —
``init_parallel_env`` over several devices or axes, a wrapper built in
a world of several processes — raises ``NotImplementedError``: the
gradient all-reduce over ``torch.distributed`` is ROADMAP item 9b.
"""
import torch

from . import env as _env

__all__ = ['init_parallel_env', 'DataParallel']



def _one_rank(what):
    n = _env.get_world_size()
    if n != 1:
        raise NotImplementedError(f'{what} in a world of {n} processes: '
                                  f'{_env.ITEM_9B}')


def init_parallel_env(n_devices=None, axes=None):
    """The reference's entry point: a ``ParallelEnv`` of rank 0 in a
    world of 1.  ``n_devices`` above 1, or ``axes`` whose sizes multiply
    past 1, raise."""
    size = 1
    for s in (dict(axes).values() if axes else ()):
        size *= max(1, int(s))
    if (n_devices is not None and int(n_devices) > 1) or size > 1:
        raise NotImplementedError(
            f'init_parallel_env(n_devices={n_devices}, axes={axes}): '
            f'{_env.ITEM_9B}')
    _one_rank('init_parallel_env')
    return _env.ParallelEnv()


class DataParallel(torch.nn.Module):
    """The reference's ``DataParallel`` at one rank: the wrapped layer
    unchanged."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        _one_rank('DataParallel')
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The loss as it is: one rank averages over itself."""
        return loss

    def apply_collective_grads(self):
        """Nothing to reduce on one rank."""

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
