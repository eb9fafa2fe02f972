"""Activation recompute: one helper for ``ParallelTrainer``'s
``strategy.recompute`` and ``fleet.utils.recompute`` (counterpart of the
reference's ``jax.checkpoint`` there).

``checkpoint(function, *args)`` runs ``function`` without keeping the
tensors its backward needs; the backward runs it again to make them
(``torch.utils.checkpoint``, non-reentrant, so gradients reach the
tensor arguments and every parameter the function closes over).
PyTorch's checkpoint replays only ``torch.autocast`` and its own default
generators; the port's AMP and dropout are its own, so the
recomputation here also

1. draws what the forward drew: each of the port's generators
   (``core.rng``: the device's, or a named stream's of an
   ``RNGStatesTracker`` scope) is put back where it stood when the
   forward first drew from it, under the scopes active when the
   forward started, and after the recomputation where it stood before
   it, so the run draws on as it would without recompute — on a
   captured CUDA graph too (``rng.region_enter``);
2. runs under the forward's AMP policy (``amp``'s level, dtype and
   lists), whatever policy is active when the backward runs;
3. writes no buffer, and reads none that the forward moved:
   BatchNorm's running statistics, spectral norm's ``u`` and a
   moving-average fake quant's ``scale`` move once, in the forward
   (``recomputing()``), as the reference keeps only the primal
   forward's new buffers; a value the forward computed from such a
   buffer before moving it (spectral norm's ``u`` and sigma, the
   moved scale) comes back to the recomputation as the forward
   computed it (``forward_value``), as ``jax.checkpoint`` replays the
   buffer's value that was passed in.

PyTorch's own default generators are stashed as usual when nothing is
being captured (``preserve_rng_state``); inside a capture they are left
alone, and only the port's draws replay.
"""
import torch
from torch.utils import checkpoint as _ckpt

from . import rng

__all__ = ['checkpoint', 'recomputing', 'forward_value']


class _Frame:
    """A region's forward (``replay`` False) or recomputation (True)
    while it runs, with the values ``forward_value`` hands between
    them."""

    def __init__(self, values, replay):
        self.values = values
        self.replay = replay
        self.pos = 0


_frames = []    # innermost last


def recomputing():
    """True while a backward recomputes a checkpointed region: buffers
    keep what the forward wrote."""
    return any(f.replay for f in _frames)


def forward_value(compute):
    """``compute()`` in a forward, noted for the region's recomputation,
    which gets the forward's value back instead, in the order the
    forward computed them.  For a value computed from a buffer the
    forward then moves (spectral norm's sigma): the recomputation would
    read the moved buffer.  Outside a recomputed region, ``compute()``."""
    i = len(_frames)
    while i and not _frames[i - 1].replay:
        i -= 1
    if i:
        frame = _frames[i - 1]
        if frame.pos >= len(frame.values):
            raise RuntimeError(
                'a recomputation asked for more forward values than its '
                'forward computed: the region must run the same code '
                'both times')
        value = frame.values[frame.pos]
        frame.pos += 1
    else:
        value = compute()
    for frame in _frames[i:]:      # the forwards running now note it
        frame.values.append(value)
    return value


def _amp_state():
    from .. import amp
    st = amp.amp_state()
    return (st.enabled, st.level, st.dtype, st.white, st.black)


def _set_amp_state(values):
    from .. import amp
    st = amp.amp_state()
    (st.enabled, st.level, st.dtype, st.white, st.black) = values


class _Forward:
    """The region's forward: stashes the AMP policy, the draws' start
    and the values ``forward_value`` computes."""

    def __init__(self, stash):
        self.stash = stash

    def __enter__(self):
        self.stash['amp'] = _amp_state()
        self.stash['rng'] = rng.region_enter()
        self.stash['values'] = []
        _frames.append(_Frame(self.stash['values'], replay=False))

    def __exit__(self, *exc):
        _frames.pop()
        rng.region_drew(self.stash['rng'])


class _Recompute:
    """The recomputation: the forward's AMP policy, draws and values, no
    buffer writes; everything back as it was on exit."""

    def __init__(self, stash):
        self.stash = stash
        self.replay = None
        self.amp = None

    def __enter__(self):
        self.amp = _amp_state()
        _set_amp_state(self.stash['amp'])
        self.replay = rng.region_replay(self.stash['rng'])
        self.replay.__enter__()
        _frames.append(_Frame(self.stash['values'], replay=True))

    def __exit__(self, *exc):
        _frames.pop()
        self.replay.__exit__(*exc)
        _set_amp_state(self.amp)


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def checkpoint(function, *args, preserve_rng_state=True, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (module docstring)."""
    stash = {}
    return _ckpt.checkpoint(
        function, *args, use_reentrant=False,
        context_fn=lambda: (_Forward(stash), _Recompute(stash)),
        preserve_rng_state=bool(preserve_rng_state) and not _capturing(),
        **kwargs)
