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
when it is.

``fused_hapi_step`` is the same fusion for ``hapi.Model.train_chunk``,
whose step also returns its finite flag and its metrics' statistics,
and ``ChunkPrefetcher`` stages ``Model.fit(fused_steps=K)``'s K-batch
chunks on a background thread, as the reference's does.
"""
import os
import queue
import threading
import time

import numpy as np
import torch

__all__ = ['ENV_VAR', 'resolve_fused_steps', 'clamp_chunk',
           'cond_carry', 'stack_batches', 'chunk_sync',
           'fused_trainer_step', 'fused_hapi_step', 'ChunkPrefetcher']

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


def fused_hapi_step(step_fn, k):
    """Fuse ``hapi.Model``'s per-step ``step_fn(*row) -> (loss, ok,
    metrics)`` into ``fused(*stacked) -> (losses, oks, metrics)``: for
    each of the K rows ``step_fn`` runs on row i of every stacked
    tensor (on the card a ``compile_cache.GraphModule`` of one step, so
    each step is one replay whose outputs the next overwrites), and its
    loss, finite flag and metric statistics are copied into row i of
    ``[K]`` f32 losses, ``[K]`` bool flags and, per metric, ``[K, ...]``
    stacked statistics (a metric whose ``compute`` returns a tuple gets
    a tuple of stacks), all on the device with no host sync.  The step
    counter and the optimizer's scalars ride on the device inside
    ``step_fn`` (the reference's scan carry), so K fused steps equal K
    calls of the unfused step.  ``k`` is the chunk length the caller
    stages."""

    def fused(*stacked):
        if int(stacked[0].shape[0]) != k:
            raise ValueError(f'fused_hapi_step: chunk of '
                             f'{int(stacked[0].shape[0])} rows, built '
                             f'for {k}')
        dev = stacked[0].device
        losses = torch.empty(k, dtype=torch.float32, device=dev)
        oks = torch.empty(k, dtype=torch.bool, device=dev)
        metrics = None
        for i in range(k):
            loss, ok, mres = step_fn(*(v[i] for v in stacked))
            losses[i].copy_(loss)
            oks[i].copy_(ok)
            if metrics is None:
                metrics = [tuple(torch.empty((k,) + tuple(x.shape),
                                             dtype=x.dtype, device=dev)
                                 for x in r)
                           if isinstance(r, (tuple, list)) else
                           torch.empty((k,) + tuple(r.shape), dtype=r.dtype,
                                       device=dev) for r in mres]
            for out, r in zip(metrics, mres):
                if isinstance(r, (tuple, list)):
                    for o, x in zip(out, r):
                        o[i].copy_(x)
                else:
                    out[i].copy_(r)
        return losses, oks, metrics or []

    return fused


# -- chunk staging ------------------------------------------------------------

class ChunkPrefetcher:
    """Double-buffered staging of K-batch chunks.

    Pulls K batches at a time from ``batch_iter``, runs ``stage_fn``
    (split + stack + device transfer) on a background thread so chunk
    N+1's host->device copy overlaps chunk N's execution, and yields
    ``(staged, n, wait_s)`` — ``wait_s`` is how long the consumer
    blocked on staging (the overlap gauge: ~0 when the double buffer
    hides the transfer).  A short tail (n < k) is yielded UNSTAGED as
    the raw batch list so the caller can run it through the per-step
    path instead of capturing a one-off K'-step graph.

    ``background=False`` (the num_workers=0 posture — there is no
    loader thread to overlap with) stages inline on the consumer
    thread; the iteration contract is identical.  A transfer the
    staging thread enqueues goes on the device's default stream, which
    the consumer's steps share, so a staged chunk is complete before
    a step reads it.
    """

    def __init__(self, batch_iter, k, stage_fn, background=True,
                 depth=2):
        self.batch_iter = iter(batch_iter)
        self.k = max(1, int(k))
        self.stage_fn = stage_fn
        self.background = bool(background)
        self.depth = max(1, int(depth))
        self._q = None
        self._thread = None
        self._err = []
        self._closed = False

    def _pull_chunk(self):
        out = []
        for _ in range(self.k):
            try:
                out.append(next(self.batch_iter))
            except StopIteration:
                break
        return out

    def _stage(self, batches):
        if len(batches) == self.k:
            return (self.stage_fn(batches), self.k)
        return (batches, len(batches))       # unstaged tail

    def _put(self, item):
        while not self._closed:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            while not self._closed:
                batches = self._pull_chunk()
                if not batches:
                    break
                if not self._put(self._stage(batches)):
                    return
        except BaseException as e:   # surface in the consumer
            self._err.append(e)
        finally:
            self._put(None)

    def __iter__(self):
        _perf = time.perf_counter
        if not self.background:
            while True:
                t0 = _perf()
                batches = self._pull_chunk()
                if not batches:
                    return
                staged, n = self._stage(batches)
                yield staged, n, _perf() - t0
            return
        self._q = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(target=self._producer,
                                        daemon=True)
        self._thread.start()
        try:
            while True:
                t0 = _perf()
                item = self._q.get()
                wait_s = _perf() - t0
                if item is None:
                    if self._err:
                        raise self._err[0]
                    return
                staged, n = item
                yield staged, n, wait_s
        finally:
            # release a producer parked on a full queue so the daemon
            # thread exits with the epoch instead of leaking
            self._closed = True
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            # bounded join: the producer's put-poll loop re-checks
            # _closed every 0.1s, so it exits within one poll tick —
            # the timeout only guards against a stage_fn wedged on a
            # device transfer
            self._thread.join(timeout=2.0)
