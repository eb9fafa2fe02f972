"""Shape bucketing and the compiled-module cache.

Counterpart of ``paddle_tpu/core/compile_cache.py``.  The reference
keeps one compiled XLA module per signature (the serving engine's
prefill per prompt bucket and chunk and decode span per batch bucket,
``generate`` per call signature, the trainer's fused step per batch
shape).  The port's counterpart of a compiled module is a CUDA graph:
``GraphModule`` captures a function once and replays the capture, one
host call in place of its thousands of launches, and ``GraphCache``
keeps one module per signature.  ``bucket_pow2`` bounds the set of
shapes, so the set of modules, as in the reference.

A graph is a CUDA object.  On the CPU (``device='cpu'``, which the
tests ask for) a ``GraphCache`` hands out the function itself, so the
same entry points run the same code eagerly.  On the card the graph is
the path: a capture that fails raises, and nothing falls back to the
eager function.
"""
import contextlib
import gc
import time

import torch

from . import rng
from ..ops import _build

__all__ = ['bucket_pow2', 'GraphModule', 'GraphCache']


def bucket_pow2(n, cap=None):
    """Next power of two >= n (>=1), optionally capped."""
    n = max(1, int(n))
    p = 1 << (n - 1).bit_length()
    if cap is not None:
        p = min(p, int(cap))
    return max(p, n)


_streams = {}


@contextlib.contextmanager
def _capture_stream(device):
    """Makes the device's side stream for warm-ups and captures the
    current stream, ordered after the work queued before and before the
    work queued after."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield stream
    caller.wait_stream(stream)


class GraphModule:
    """``fn(*inputs)`` on the card as one captured CUDA graph.

    The first call is the warm-up: the inputs are copied into static
    device buffers (allocated outside any graph), and ``fn`` runs on
    them eagerly on the capture stream.  That builds the kernels
    (``_build.load`` runs nvcc at a first launch, which must never
    happen inside a capture), makes cuBLAS's handle and workspace for
    that stream and any lazy state (an optimizer's moments), and its
    outputs are the call's result.  Then ``fn`` is captured over the
    same buffers, with the device's random generator registered
    (``core.rng``), so each replay draws what eager calls would.  Every
    later call copies its inputs into the buffers on the current
    stream, replays, adds the capture's kernel launches to the counts
    (``_build.capture_launches``) and returns the static outputs, which
    the next call overwrites.  ``fn`` must not read a device value on
    the host: a capture fails loudly on a sync, and that raises.

    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
    modules, or None for a private one (``GraphCache`` decides).

    ``stay_eager``: called with no arguments after the warm-up; when it
    returns True nothing is captured, ``eager`` is set, and every later
    call runs ``fn`` on its own inputs (``jit.to_static`` keeps a
    signature whose warm-up read a tensor predicate on the host this
    way)."""

    def __init__(self, fn, device, pool=None, stay_eager=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.stay_eager = stay_eager
        self.eager = False
        self.graph = None
        self.inputs = None
        self.outputs = None
        self.launches = None       # _build.CapturedLaunches of one replay
        self.capture_s = None
        self.replays = 0

    def __call__(self, *inputs):
        if self.eager:
            return self.fn(*inputs)
        if self.graph is None:
            return self._warm_up_and_capture(inputs)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        with _build.counts_lock:
            self.launches.replayed()
            self.replays += 1
        return self.outputs

    def _warm_up_and_capture(self, inputs):
        static = tuple(torch.empty(x.shape, dtype=x.dtype,
                                   device=self.device) for x in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src, non_blocking=True)
        with _capture_stream(self.device) as stream:
            out = self.fn(*static)
        if self.stay_eager is not None and self.stay_eager():
            self.eager = True
            return out
        graph = torch.cuda.CUDAGraph()
        rng.register_generators(graph, self.device)
        # an unreachable graph (in a reference cycle) collected during
        # the capture would end it: freeing a graph is not permitted
        # while a stream captures
        gc.collect()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.capture_launches() as tally:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    outputs = self.fn(*static)
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.graph, self.inputs, self.outputs = graph, static, outputs
        self.launches = tally
        return out


class GraphCache:
    """One module per signature: a ``GraphModule`` on the card, ``fn``
    itself on the CPU.

    ``shared_pool``: every graph of this cache allocates from one
    memory pool.  That is safe when no graph's live outputs can be
    taken by another: each module keeps its static outputs referenced
    (so the allocator never hands them out again), its inputs live
    outside the pool, and the graphs run on one stream, one at a time.
    Then a graph may overwrite only what another freed inside its own
    capture (intermediates), in any replay order.  The serving engine's
    decode and prefill graphs share one pool this way (``share_with``
    names the cache whose pool a second cache takes), and so do
    ``generate``'s; a trainer's step graphs keep private pools (a
    trainer has one batch signature as a rule)."""

    def __init__(self, device, shared_pool=False, share_with=None):
        self.device = torch.device(device)
        self.shared_pool = shared_pool or share_with is not None
        self.share_with = share_with
        self.pool = None
        self.modules = {}

    def _shared_pool(self):
        owner = self.share_with if self.share_with is not None else self
        if owner.pool is None:
            owner.pool = torch.cuda.graph_pool_handle()
        return owner.pool

    def clear(self):
        """Drops every module (a graph bakes in the addresses of the
        tensors it read: after a model's layers are swapped, its
        modules must be made anew)."""
        self.modules.clear()

    def module(self, sig, fn, warmup_inputs=None):
        """The module of ``sig``, made from ``fn`` at first use; a new
        module is called once on ``warmup_inputs`` if given (on the card
        that warms it up and captures it)."""
        mod = self.modules.get(sig)
        if mod is not None:
            return mod
        if self.device.type != 'cuda':
            mod = fn
        else:
            mod = GraphModule(fn, self.device, pool=self._shared_pool()
                              if self.shared_pool else None)
        if warmup_inputs is not None:
            mod(*warmup_inputs)
        self.modules[sig] = mod
        return mod
