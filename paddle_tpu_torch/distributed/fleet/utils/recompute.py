"""Activation recompute as a user-facing function (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``).

``recompute(function, *args)`` runs ``function`` without storing its
activations for the backward, which runs it again from its inputs
(``core.recompute.checkpoint``, the helper ``ParallelTrainer``'s
``strategy.recompute`` uses too): the recomputation draws the forward's
dropout masks, runs under the forward's AMP policy and writes no
buffer.  Gradients reach the tensor arguments and the parameters the
function closes over, eagerly and under a captured step.
``preserve_rng_state`` (default True) also replays PyTorch's default
generators where nothing is being captured.
"""
from ....core.recompute import checkpoint

__all__ = ['recompute']


def recompute(function, *args, **kwargs):
    preserve_rng_state = kwargs.pop('preserve_rng_state', True)
    return checkpoint(function, *args,
                      preserve_rng_state=preserve_rng_state, **kwargs)
