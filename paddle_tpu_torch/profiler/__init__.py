"""Profiler of the port (counterpart of ``paddle_tpu/profiler``) on
``torch.profiler``.

``start_profiler``/``stop_profiler`` bracket a trace window over the
host and, on the card, the device (``torch.profiler``'s CPU and CUDA
activities); the stop synchronizes the device, so the window's queued
work lands in it, writes the window's Chrome trace under ``logdir``
and returns ``logdir``, or with ``parse=True`` the parsed
:class:`trace.TraceProfile` (per-kernel device time, and the
``record_function`` ranges).  ``profiler`` is the context form,
``cuda_profiler`` the reference's nvprof hook as such a window,
``reset_profiler`` restarts an open window, ``Profiler`` the 2.x
object with its step timer, ``RecordEvent`` a named range
(``torch.profiler.record_function``) and ``StepTimer`` telemetry's.
The sampled capture of a training or serving loop is
``telemetry.profile`` (``ParallelTrainer(profile=)``,
``Model.fit(profile=)``, ``PADDLE_TPU_PROFILE``).

``op_summary(fn, *args)`` is the reference's per-op table of one step
that is never executed: where the reference reads the compiled HLO,
the port runs ``fn`` on fake tensors (``FakeTensorMode``: shapes and
dtypes, no data, no launch, no draw) and counts each dispatched
operator — ``aten`` ops and the hand-written kernels' operators
(``paddle_tpu_torch::*``, forward and backward) — with the bytes of
its outputs, the traffic it writes.  Views and the dispatcher's own
plumbing are left out, as the reference leaves out parameters,
constants and tuples.
"""
import contextlib
import os
import sys
import tempfile
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..telemetry import StepTimer  # noqa: F401
from . import trace  # noqa: F401
from .trace import (TraceProfile, find_traces,  # noqa: F401
                    match_collectives, parse_trace)

__all__ = ['Profiler', 'start_profiler', 'stop_profiler', 'profiler',
           'reset_profiler', 'cuda_profiler', 'StepTimer', 'RecordEvent',
           'op_summary', 'trace', 'TraceProfile', 'parse_trace',
           'find_traces', 'match_collectives']

DEFAULT_LOGDIR = os.path.join(tempfile.gettempdir(),
                              'paddle_tpu_torch_profile')

SORT_KEYS = ('total', 'bytes', 'calls')


# -- op_summary: one step traced on fake tensors ------------------------------

def _plumbing(func):
    """Ops that move no data: the dispatcher's ``prim::`` ops, and views
    (outputs that alias an input without writing it)."""
    schema = func._schema
    if schema.name.startswith('prim::') or \
            schema.name in ('aten::detach', 'aten::lift_fresh'):
        return True
    returns = schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _out_bytes(out):
    total = 0
    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


class _OpCounter(TorchDispatchMode):
    """Calls and output bytes of every dispatched operator."""

    def __init__(self):
        super().__init__()
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _plumbing(func):
            name = func._schema.name.replace('aten::', '')
            row = self.rows.setdefault(name, {'opcode': name, 'calls': 0,
                                              'bytes': 0})
            row['calls'] += 1
            row['bytes'] += _out_bytes(out)
        return out


def _fake_trace(fn, *args, swap=None, **kwargs):
    """``fn(*args, **kwargs)`` on fake tensors, counted: ``{opcode:
    {opcode, calls, bytes}}``.  ``swap(mode)``, a context manager
    factory, puts fake copies in place of state ``fn`` writes (a
    trainer's parameters, gradients and optimizer slots)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs, fkwargs = pytree.tree_map_only(
        torch.Tensor, mode.from_tensor, (args, kwargs))
    counter = _OpCounter()
    with (swap(mode) if swap is not None else contextlib.nullcontext()):
        with mode, counter:
            fn(*fargs, **fkwargs)
    return counter.rows


def op_summary(fn, *args, sorted_by='total', top=25, stream=None,
               print_table=True, totals=None, swap=None, **kwargs):
    """Per-op table of one call of ``fn(*args, **kwargs)``, traced on
    fake tensors and never executed (module docstring).  Each row is
    ``{opcode, calls, bytes, ratio}``: an operator's calls, its output
    bytes and their share of the total.  ``sorted_by`` ``'total'`` or
    ``'bytes'`` ranks by bytes, ``'calls'`` by calls.  ``totals`` (a
    dict) heads the printed table.  Returns the rows."""
    if sorted_by not in SORT_KEYS:
        raise ValueError(
            f"sorted_by must be 'total', 'bytes' or 'calls', "
            f'got {sorted_by!r}')
    agg = _fake_trace(fn, *args, swap=swap, **kwargs)
    grand = sum(r['bytes'] for r in agg.values()) or 1
    key = 'calls' if sorted_by == 'calls' else 'bytes'
    rows = sorted(agg.values(), key=lambda r: r[key], reverse=True)
    for r in rows:
        r['ratio'] = r['bytes'] / grand
    if print_table:
        out = stream or sys.stdout
        print('------------------------- op summary '
              '-------------------------', file=out)
        for k, v in (totals or {}).items():
            print(f'module {k}: {v:.3e}', file=out)
        print(f'{"op":<40}{"calls":>8}{"out bytes":>16}{"ratio":>8}',
              file=out)
        for r in rows[:top]:
            print(f'{r["opcode"]:<40}{r["calls"]:>8}'
                  f'{r["bytes"]:>16,}{r["ratio"]:>8.2%}', file=out)
        if len(rows) > top:
            rest = sum(r['bytes'] for r in rows[top:])
            print(f'{"... (" + str(len(rows) - top) + " more)":<40}'
                  f'{"":>8}{rest:>16,}{rest / grand:>8.2%}', file=out)
    return rows


# -- trace windows -------------------------------------------------------------

def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_active = []    # [(torch.profiler.profile, logdir)] while a window is open


def start_profiler(state=None, tracer_option=None, logdir=DEFAULT_LOGDIR):
    """Open a trace window of the host and the device; returns
    ``logdir``, where ``stop_profiler`` writes it.  ``state`` and
    ``tracer_option`` are the reference's, unread."""
    if _active:
        raise RuntimeError('a profiler window is already open: '
                           'stop_profiler() first')
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    _active.append((prof, logdir))
    return logdir


def _close(export):
    prof, logdir = _active.pop()
    _sync()
    prof.__exit__(None, None, None)
    if not export:
        return None, logdir
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f'paddle_tpu_torch.{time.time_ns()}.'
                                f'{os.getpid()}.trace.json.gz')
    prof.export_chrome_trace(path)
    return path, logdir


def stop_profiler(sorted_key=None, profile_path=None, parse=False):
    """Close the window and write its trace.  Returns the logdir, or
    with ``parse=True`` the parsed :class:`TraceProfile` (None when no
    window was open)."""
    if not _active:
        return None
    path, logdir = _close(export=True)
    return parse_trace(path) if parse else logdir


def reset_profiler():
    """Drop what the open window gathered so far: it restarts on the
    same logdir (nothing to do with none open)."""
    if _active:
        _, logdir = _close(export=False)
        start_profiler(logdir=logdir)


@contextlib.contextmanager
def profiler(state=None, sorted_key=None, logdir=DEFAULT_LOGDIR):
    start_profiler(state, logdir=logdir)
    try:
        yield
    finally:
        stop_profiler(sorted_key)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The reference's nvprof hook: a trace window of the body, its
    CUDA kernels included on the card."""
    start_profiler()
    try:
        yield
    finally:
        stop_profiler()


class RecordEvent:
    """A named range of the trace (``torch.profiler.record_function``):
    on the host's timeline and, on the card, the device's."""

    def __init__(self, name):
        self.name = name
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        self._ctx = None


class Profiler:
    """The 2.x ``paddle.profiler.Profiler`` shape: a window from
    ``start`` to ``stop`` and a step timer ``step`` drives."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 logdir=DEFAULT_LOGDIR):
        self.logdir = logdir
        self.timer = StepTimer()
        self._running = False

    def start(self):
        start_profiler(logdir=self.logdir)
        self._running = True
        self.timer.start()

    def stop(self):
        if self._running:
            stop_profiler()
            self._running = False

    def step(self, sync=None):
        self.timer.stop(sync)
        self.timer.start()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def summary(self, *a, **k):
        return self.timer.summary()
