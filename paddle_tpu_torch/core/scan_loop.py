"""K optimizer steps in one call (counterpart of
``paddle_tpu/core/scan_loop.py``).

The reference fuses K train steps into one XLA module (a ``lax.scan``)
so the loop pays one dispatch per chunk instead of one per step.  The
port's counterpart replays one CUDA graph of a whole step (forward,
backward, the optimizer's update), captured once per batch signature
(``core.compile_cache``), K times: one host call a step in place of
thousands of launches, and no host sync in the chunk.  The stacked
batches arrive with a leading K dimension, the per-step losses go back
as one device tensor, and the step counter advances by K, as in the
reference.

Under the NaN guard the step also returns its finite flag, and
``fused_trainer_step``'s guarded form gathers the K flags as the
chunk's mask, which ``chunk_sync`` reads back: the one host read of a
guarded chunk.  The step itself keeps a non-finite step's update out of
the parameters and state (``resilience.guard_update``), and the
trainer's step counter, which lives on the device there, advances
through ``cond_carry`` by the finite steps only.

``fused_steps`` is off by default; ``PADDLE_TPU_FUSED_STEPS`` supplies
a default K for runs that cannot change code.  The watchdog is not
ported, so ``ParallelTrainer`` passes no budget and ``clamp_chunk``
passes K through; the function keeps the reference's contract for
when it is.  The reference's chunk prefetcher waits for a later slice.
"""
import os

import numpy as np
import torch

__all__ = ['ENV_VAR', 'resolve_fused_steps', 'clamp_chunk',
           'cond_carry', 'stack_batches', 'chunk_sync',
           'fused_trainer_step']

ENV_VAR = 'PADDLE_TPU_FUSED_STEPS'

_OFF = ('', '0', 'off', 'false', 'none', 'no')


def resolve_fused_steps(arg=None):
    """The chunk length a loop should fuse: an explicit ``fused_steps=``
    value wins (``False``/``0`` force off); ``None`` defers to the
    ``PADDLE_TPU_FUSED_STEPS`` env var.  Returns an int K >= 1, or 0
    (off)."""
    if arg is None:
        arg = os.environ.get(ENV_VAR)
        if arg is None:
            return 0
    if arg is False:
        return 0
    if isinstance(arg, str):
        if arg.strip().lower() in _OFF:
            return 0
        arg = int(arg)
    k = int(arg)
    if k < 0:
        raise ValueError(f'fused_steps must be >= 0, got {k}')
    return k


def clamp_chunk(k, budget=None, est_step_s=None):
    """K clamped so that K steps of ``est_step_s`` fit the watchdog's
    per-step deadline ``budget.step_s``; K itself (at least 1) without a
    budget or an estimate."""
    k = max(1, int(k))
    if budget is None or not est_step_s or est_step_s <= 0:
        return k
    step_s = getattr(budget, 'step_s', None)
    if not step_s:
        return k
    return max(1, min(k, int(step_s // float(est_step_s))))


def cond_carry(ok, new_carry, old_carry):
    """The carry of a guarded step: each tensor of ``new_carry`` where
    ``ok`` (a 0-d bool tensor) is set, of ``old_carry`` where not, by a
    select on the device (no host branch, so a graph can capture it)."""
    return [torch.where(ok, a, b) for a, b in zip(new_carry, old_carry)]


def stack_batches(batches):
    """A list of K per-step batches (each a tuple or list of arrays) ->
    one tuple of tensors with a leading K dim.  Host (numpy) fields
    stack on the host (``step_fused`` uploads each in one transfer);
    tensor fields stack where they are, with no read back to the
    host."""
    if not batches:
        raise ValueError('stack_batches needs at least one batch')
    out = []
    for j in range(len(batches[0])):
        col = [b[j] for b in batches]
        if all(isinstance(x, (np.ndarray, np.generic)) for x in col):
            out.append(torch.from_numpy(np.stack(col)))
        else:
            out.append(torch.stack([torch.as_tensor(x) for x in col]))
    return tuple(out)


def chunk_sync(x):
    """The one sanctioned host read of a guarded chunk: ``x`` (the K-step
    finite mask) as numpy.  It reads with the CUDA sync debug mode off,
    so a chunk run under ``torch.cuda.set_sync_debug_mode('error')``
    fails on any other sync."""
    if not x.is_cuda:
        return x.numpy()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return x.cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def fused_trainer_step(step_fn, load_step, nan_guard=False):
    """Fuse ``ParallelTrainer``'s per-step ``step_fn(*row) -> loss`` into
    ``fused(*stacked) -> losses``: for each of the K rows,
    ``load_step(i)`` puts step i's per-step values in place (the
    optimizer's scalars, on the device's stream), ``step_fn`` runs on
    row i of every stacked tensor, and its loss is copied into row i of
    the result, ``[K]`` f32 on the device, with no host sync.  On the
    card ``step_fn`` is a ``compile_cache.GraphModule`` of one step, so
    each step is one replay and its loss a static output that the next
    replay overwrites; on the CPU it is the eager step.

    ``nan_guard``: ``step_fn`` returns ``(loss, ok)``, and ``fused``
    returns ``(losses, oks)``, the K finite flags as a ``[K]`` bool
    device tensor beside the losses.  ``load_step`` may be None (a
    guarded step loads its own scalars)."""

    def fused(*stacked):
        k = int(stacked[0].shape[0])
        dev = stacked[0].device
        losses = torch.empty(k, dtype=torch.float32, device=dev)
        oks = torch.empty(k, dtype=torch.bool, device=dev) \
            if nan_guard else None
        for i in range(k):
            if load_step is not None:
                load_step(i)
            out = step_fn(*(v[i] for v in stacked))
            if nan_guard:
                out, ok = out
                oks[i].copy_(ok)
            losses[i].copy_(out)
        return (losses, oks) if nan_guard else losses

    return fused
