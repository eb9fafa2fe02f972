"""paddle_tpu_torch.telemetry — run telemetry of the port (counterpart
of ``paddle_tpu/telemetry``, with its event vocabulary, its JSONL files
and its environment variables, so ``tools/run_report.py`` reads the
port's runs as it reads the reference's):

* **spans** — ``with telemetry.span('compile'):`` nested
  monotonic-clock timers, aggregated per name and streamed as events;
* **counters / gauges** — ``telemetry.add``/``set_gauge``;
* **typed events** — ``serve_step``, ``serve_request``,
  ``serve_trace``, ``serve_reject``, ``timeout``, ``fleet_event``,
  ``profile_capture``, ``memory_sample``, ``memory_compiled``, … (the
  vocabulary is ``EVENT_KINDS``);
* a **flight recorder** — the bounded ring of the last N events,
  dumped by ``dump_flight`` (and by the crash hook on an unhandled
  exception);
* **exporters** — a rank-tagged JSONL stream per host
  (``telemetry-r<rank>.jsonl``), optionally TensorBoard event files;
* the **live plane** — ``LiveAggregator``, SLO/drift/memory monitors,
  the ``MetricsServer`` (``/metrics``, ``/status.json``), the memory
  sampler and the step profiler.

The contract that makes this safe to leave on: **the step path is
sync-free**.  Per-step scalars are buffered as device tensors by
``StepAccumulator`` and read back only every ``flush_interval`` steps;
everything else emits at boundary rate, from host state.

Usage::

    from paddle_tpu_torch import telemetry
    telemetry.enable('/runs/r7/telemetry')       # JSONL + step stats
    ...serve...
    $ python tools/run_report.py /runs/r7/telemetry

Hard kill switch: ``PADDLE_TPU_TELEMETRY=0`` (every entry point
no-ops).  The reference's training-cluster plane
(``telemetry.cluster``) waits for a later slice of the port.
"""
import contextlib
import os
import sys

from .recorder import (  # noqa: F401
    Recorder, get_recorder, reset, hard_off, EVENT_KINDS)
from .stepstats import (  # noqa: F401
    StepAccumulator, StepTimer, percentiles)
from .exporters import (  # noqa: F401
    JsonlWriter, ScalarAdapter, TensorBoardWriter, TeeWriter)
from .profile import (  # noqa: F401
    ProfileSchedule, StepProfiler, step_profiler, capture,
    resolve_schedule)
from .live import (  # noqa: F401
    LiveAggregator, RollingWindow, RateCounter)
from .monitors import (  # noqa: F401
    SLOMonitor, DriftMonitor, MemoryMonitor)
from .memory import (  # noqa: F401
    MemConfig, MemorySampler, resolve_memstats, note_compiled,
    maybe_note_compiled, note_graph_capture, ensure_sampler,
    stop_sampler)
from .httpd import (  # noqa: F401
    MetricsServer, resolve_metrics_port, attach_source)

__all__ = [
    'Recorder', 'get_recorder', 'reset', 'hard_off', 'EVENT_KINDS',
    'StepAccumulator', 'StepTimer', 'percentiles',
    'JsonlWriter', 'ScalarAdapter', 'TensorBoardWriter', 'TeeWriter',
    'ProfileSchedule', 'StepProfiler', 'step_profiler', 'capture',
    'resolve_schedule',
    'LiveAggregator', 'RollingWindow', 'RateCounter',
    'SLOMonitor', 'DriftMonitor', 'MemoryMonitor',
    'MemConfig', 'MemorySampler', 'resolve_memstats', 'note_compiled',
    'maybe_note_compiled', 'note_graph_capture', 'ensure_sampler',
    'stop_sampler',
    'MetricsServer', 'resolve_metrics_port', 'attach_source',
    'enable', 'disable', 'enabled', 'active',
    'event', 'add', 'set_gauge', 'span', 'events',
    'step_accumulator', 'dump_flight', 'flight_dir',
]

_enabled = False
_prev_excepthook = None
_crash_dir = None


def active():
    """True when telemetry records at all (the default; in-memory
    flight ring + counters).  False only under PADDLE_TPU_TELEMETRY=0."""
    return not hard_off()


def enabled():
    """True when enable() turned on the JSONL export + per-step
    accumulation (the opt-in, heavier-weight layer)."""
    return _enabled and not hard_off()


def enable(log_dir=None, flush_interval=32, crash_dump=True,
           max_events=None, tensorboard=False):
    """Turn on full telemetry: stream events to
    ``<log_dir>/telemetry-r<rank>.jsonl``, set the
    ``step_accumulator`` flush interval, and (default) install a crash hook that dumps
    the flight recorder on an unhandled exception.

    log_dir=None keeps everything in memory (step accumulation and
    flight dumps still work; nothing streams to disk).

    tensorboard=True additionally writes TensorBoard-native event
    files (``events.out.tfevents.*``) next to the JSONL: the SAME
    buffered device scalars — ``steps`` flushes and ``scalar``
    records — become TB scalar points at their flush boundary, so the
    export adds zero per-step host syncs (stdlib-only writer, see
    exporters.TensorBoardWriter)."""
    global _enabled, _crash_dir
    if hard_off():
        return None
    rec = get_recorder()
    if max_events is not None:
        # resize the ring in place, keeping the newest events
        from collections import deque
        rec._events = deque(rec._events, maxlen=max_events)
    rec.flush_interval = max(1, int(flush_interval))
    if log_dir is not None:
        writer = JsonlWriter(log_dir)
        if tensorboard:
            writer = TeeWriter(writer, TensorBoardWriter(log_dir))
        old = rec.attach_writer(writer)
        if old is not None:
            old.close()
        _crash_dir = os.path.abspath(log_dir)
    _enabled = True
    if crash_dump:
        _install_crash_hook()
    meta = {'pid': os.getpid(), 'argv': list(sys.argv),
            'flush_interval': rec.flush_interval}
    try:
        meta.update(_backend_meta())
    except Exception:
        pass
    rec.event('run_meta', **meta)
    return rec


def _backend_meta():
    """run_meta's backend fields from torch: ``cuda`` with the card's
    name where CUDA is up, else ``cpu``; the process count from
    ``torch.distributed`` when it is initialized."""
    import torch
    meta = {'backend': 'cpu', 'process_count': 1}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        meta['backend'] = 'cuda'
        meta['device_kind'] = torch.cuda.get_device_name(
            torch.cuda.current_device())
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        meta['process_count'] = dist.get_world_size()
    return meta


def disable():
    """Detach the JSONL writer and stop per-step accumulation; the
    in-memory flight ring keeps recording (see active())."""
    global _enabled
    _enabled = False
    rec = get_recorder()
    w = rec.attach_writer(None)
    if w is not None:
        w.close()
    _remove_crash_hook()


def flight_dir():
    """The directory crash dumps land in (the enable() log_dir), or
    None — call sites with a better home (a checkpoint dir) pass their
    own path to dump_flight()."""
    return _crash_dir


# -- module-level conveniences (the emission API call sites use) --------------

def event(kind, **data):
    if hard_off():
        return None
    return get_recorder().event(kind, **data)


def add(name, n=1):
    if hard_off():
        return
    get_recorder().add(name, n)


def set_gauge(name, value):
    if hard_off():
        return
    get_recorder().set_gauge(name, value)


def events(kind=None):
    return get_recorder().events(kind)


def span(name, **attrs):
    """``with telemetry.span('compile'): ...`` — no-op under the hard
    kill switch."""
    if hard_off():
        return contextlib.nullcontext()
    return get_recorder().span(name, **attrs)


def step_accumulator(tag='train', flush_interval=None):
    """A StepAccumulator for a step loop, or None when full telemetry
    is off — loops guard with ``if acc is not None``."""
    if not enabled():
        return None
    return StepAccumulator(tag=tag, flush_interval=flush_interval)


def dump_flight(path):
    """Write the flight-recorder JSON to `path` (atomic; never
    raises).  Returns the path or None."""
    if hard_off():
        return None
    return get_recorder().dump_flight(path)


# -- crash hook ---------------------------------------------------------------

def _crash_hook(exc_type, exc, tb):
    try:
        d = _crash_dir or '.'
        from .recorder import _rank
        get_recorder().event_unlocked(
            'crash', error=repr(exc)[:300],
            exc_type=getattr(exc_type, '__name__', str(exc_type)))
        get_recorder().dump_flight(
            os.path.join(d, f'flightrec-crash-r{_rank()}.json'))
    except Exception:
        pass
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def _install_crash_hook():
    global _prev_excepthook
    if sys.excepthook is _crash_hook:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_hook


def _remove_crash_hook():
    global _prev_excepthook
    if sys.excepthook is _crash_hook:
        sys.excepthook = _prev_excepthook or sys.__excepthook__
        _prev_excepthook = None
