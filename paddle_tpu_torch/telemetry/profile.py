"""Sampled self-profiling: capture N steps of device trace every M
steps (the port's counterpart of ``paddle_tpu/telemetry/profile.py``,
with its schedule grammar, its window arithmetic on exact step ids and
its ``profile_capture`` event).

1. **capture** — ``torch.profiler.profile`` over the CPU and CUDA
   activities around a small window of steps, on a
   :class:`ProfileSchedule` (default OFF; opt in per run with
   ``ServeConfig(profile=...)`` or globally with the
   ``PADDLE_TPU_PROFILE`` env var).  Where the reference calls
   ``jax.profiler.start_trace``/``stop_trace``, the port starts and
   stops one profiler, synchronizes the device before the stop (the
   window's work runs asynchronously and must land in the trace) and
   exports the window's Chrome trace as
   ``<dir>/trace-<name>-step<lo:06d>/trace.json.gz``, one directory a
   window, named as the reference names them;
2. **parse** — ``profiler.trace.parse_trace`` of the exported trace:
   its device events (kernels and memory copies on the GPU timeline;
   the CPU ops where there is none) become the window's device time,
   and kernels whose name carries ``nccl`` count as collective time;
3. **emit** — one ``profile_capture`` event per window with the
   reference's fields (window, step range, dir, trace, n_ops,
   n_events, device_total_us, collective_total_us, source,
   device_us_per_step, collective_us_per_step, collective_frac,
   collective_observed) and the ``profile.*`` gauges.

The reference also joins each profiled collective with the compiled
module's HLO census (``analysis.hlo.collective_instrs``) into
``collective_observed`` events for the cost-model fit.  A CUDA graph
has no HLO and the port has no cost model, so there is no counterpart:
``collective_observed`` is always 0 here and no such event is emitted.

The cost contract: OUTSIDE a window, ``observe()`` is one integer
compare — no host sync, no device traffic.  The window close pays one
device synchronize plus the export and parse on the host.

Schedule spec grammar (env var and string form)::

    PADDLE_TPU_PROFILE=1                      # defaults: 2 steps @ 10,
                                              # every 200, 4 windows
    PADDLE_TPU_PROFILE=every=100,steps=3,start=5,limit=2,dir=/tmp/p
    ServeConfig(profile=True) / profile='every=50,steps=2'
    ServeConfig(profile={'every': 50, 'steps': 2})
    ServeConfig(profile=False)                # force off, beats env
"""
import contextlib
import os
import time

from . import recorder as _rec

__all__ = ['ProfileSchedule', 'StepProfiler', 'step_profiler',
           'capture', 'resolve_schedule', 'ENV_VAR']

ENV_VAR = 'PADDLE_TPU_PROFILE'

_OFF = ('', '0', 'off', 'false', 'none', 'no')


class ProfileSchedule:
    """When to capture: ``steps``-step windows starting at ``start``
    and every ``every`` steps after, at most ``limit`` windows.
    Windows never include step 0 — the first step of a fresh compile
    measures XLA, not the model."""

    __slots__ = ('every', 'steps', 'start', 'limit', 'dir')

    def __init__(self, every=200, steps=2, start=10, limit=4,
                 dir=None):
        self.every = max(1, int(every))
        self.steps = max(1, int(steps))
        self.start = max(1, int(start))
        self.limit = max(1, int(limit))
        self.dir = dir

    def starts_at(self, step, windows_done=0):
        """True when a capture window should open at `step`."""
        if windows_done >= self.limit or step < self.start:
            return False
        return (step - self.start) % self.every == 0

    def to_dict(self):
        return {'every': self.every, 'steps': self.steps,
                'start': self.start, 'limit': self.limit}

    def __repr__(self):
        return (f'ProfileSchedule(every={self.every}, '
                f'steps={self.steps}, start={self.start}, '
                f'limit={self.limit})')

    @classmethod
    def parse(cls, spec):
        """True / 'on' → defaults; 'k=v,…' / dict → configured;
        off-ish values → None."""
        if spec is None or spec is False:
            return None
        if spec is True:
            return cls()
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(**spec)
        s = str(spec).strip()
        if s.lower() in _OFF:
            return None
        if s.lower() in ('1', 'on', 'true', 'yes'):
            return cls()
        kw = {}
        for part in s.split(','):
            part = part.strip()
            if not part:
                continue
            if '=' not in part:
                raise ValueError(
                    f'bad {ENV_VAR} spec {spec!r}: expected '
                    "'key=value,…' with keys every/steps/start/"
                    'limit/dir')
            k, v = part.split('=', 1)
            k = k.strip()
            if k == 'dir':
                kw[k] = v.strip()
            elif k in ('every', 'steps', 'start', 'limit'):
                kw[k] = int(v)
            else:
                raise ValueError(
                    f'bad {ENV_VAR} key {k!r} in {spec!r}')
        return cls(**kw)

    @classmethod
    def from_env(cls):
        return cls.parse(os.environ.get(ENV_VAR))


def resolve_schedule(profile=None):
    """The schedule a loop should run: an explicit ``profile=`` value
    wins (``False`` forces off); ``None`` defers to the
    ``PADDLE_TPU_PROFILE`` env var — so any run can be profiled
    without a code change.  Returns a ProfileSchedule or None."""
    if profile is None:
        return ProfileSchedule.from_env()
    return ProfileSchedule.parse(profile)


def _parse_chrome_trace(path):
    """Device time of one exported trace: the reference's
    ``TraceProfile.summary()`` fields, from the port's one trace parser
    (``profiler.trace``)."""
    from ..profiler.trace import parse_trace
    return parse_trace(path).summary()


_warmed = []


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler():
    """Profile nothing, once a process.  torch.profiler's first use
    imports and initialises its machinery, seconds of host time; a
    ``StepProfiler`` pays it when it is armed, in the thread that arms
    it, so its first window does not stall the loop it watches."""
    if _warmed:
        return
    import torch
    with torch.profiler.profile(activities=_activities()):
        pass
    _warmed.append(True)


class StepProfiler:
    """Drives sampled capture windows over one step loop.

    Call :meth:`observe` once per step AFTER the step's dispatch,
    passing the step index (``sync=`` what the window close should wait
    for: a CUDA event, a device tensor, or True).  Call :meth:`close`
    at loop end — an open window is finalized.

    Never raises out of observe/close: profiling is evidence, not a
    blocker — a failed capture lands as an ``error`` field on the
    ``profile_capture`` event.
    """

    def __init__(self, schedule, base_dir=None, name='train',
                 num_partitions=None):
        self.schedule = schedule
        self.name = name
        self.num_partitions = num_partitions
        self.base_dir = base_dir or schedule.dir
        self.windows = []       # summary dict per closed window
        self._active = None     # {'lo': step, 'hi': step, 'dir': …}
        self._last_step = None  # newest step observe() saw
        self._prof = None
        try:
            warm_profiler()
        except Exception:       # profiling must never kill the loop
            pass

    # -- directory -----------------------------------------------------------
    def _ensure_dir(self):
        if self.base_dir is None:
            import tempfile
            self.base_dir = tempfile.mkdtemp(
                prefix='paddle_tpu_profile_')
        os.makedirs(self.base_dir, exist_ok=True)
        return self.base_dir

    # -- loop hooks ----------------------------------------------------------
    def observe(self, step_no, sync=None, span=1):
        """One step just dispatched; `step_no` is its 0-based index in
        THIS loop.  Cheap outside a window (an int compare); opens the
        trace when the NEXT step starts a window, closes + parses when
        this step completed one.

        ``span=K`` (one dispatch covering K steps, as a serving decode
        span does) declares that this ONE dispatch covered steps
        ``step_no .. step_no+K-1``: windows then open at exact span
        boundaries and close on whole spans, so a window names exact
        step ids, never a blurred range."""
        try:
            span = max(1, int(span))
            last = step_no + span - 1
            self._last_step = last
            if self._active is not None:
                if last >= self._active['hi']:
                    # a span never splits: the window's hi stretches
                    # to this span's exact last step id
                    self._active['hi'] = max(self._active['hi'], last)
                    self._stop(sync)
                return
            # does a scheduled start land inside the NEXT span?
            for s in range(last + 1, last + span + 1):
                if self.schedule.starts_at(s, len(self.windows)):
                    import math
                    n_chunks = math.ceil(self.schedule.steps / span)
                    self._start(last + 1, hi=last + n_chunks * span)
                    break
        except Exception:       # profiling must never kill the loop
            self._active = None
            self._prof = None

    def close(self, sync=None):
        """Finalize at loop end: an open window is parsed as-is."""
        try:
            if self._active is not None:
                self._stop(sync)
        except Exception:
            self._active = None
            self._prof = None

    # -- window mechanics ----------------------------------------------------
    def _start(self, lo, hi=None):
        import torch
        d = os.path.join(self._ensure_dir(),
                         f'trace-{self.name}-step{lo:06d}')
        os.makedirs(d, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
        self._prof = prof
        self._active = {'lo': lo,
                        'hi': (hi if hi is not None
                               else lo + self.schedule.steps - 1),
                        'dir': d, 't0': time.perf_counter()}

    def _stop(self, sync):
        import torch
        from .stepstats import _wait
        win, prof = self._active, self._prof
        self._active = self._prof = None
        err = None
        try:
            # the window's work runs asynchronously; it must finish
            # before the profiler stops or the window would be empty
            if sync is not None:
                _wait(sync)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        except Exception:
            pass
        trace = os.path.join(win['dir'], 'trace.json.gz')
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace)
        except Exception as e:
            err = f'stop_trace: {e!r}'
        ran = self._last_step is None or self._last_step >= win['lo']
        hi = win['hi'] if self._last_step is None \
            else max(win['lo'], min(win['hi'], self._last_step))
        summary = {'window': len(self.windows),
                   'step_lo': win['lo'], 'step_hi': hi,
                   'steps': hi - win['lo'] + 1,
                   'dir': win['dir'], 'name': self.name,
                   'wall_s': round(time.perf_counter() - win['t0'], 4)}
        if err is None and not ran:
            err = 'window opened but no step ran before close()'
        if err is None:
            try:
                self._parse_and_emit(trace, summary)
            except Exception as e:
                err = f'parse: {e!r}'
        if err is not None:
            summary['error'] = err
        self.windows.append(summary)
        from . import event as _event
        _event('profile_capture', **summary)

    def _parse_and_emit(self, trace, summary):
        if not os.path.exists(trace):
            summary['error'] = 'no trace file emitted'
            return
        prof = _parse_chrome_trace(trace)
        summary['trace'] = trace
        summary.update(prof)
        n_steps = summary['steps']
        devices = self.num_partitions or 1
        per_step = prof['device_total_us'] / (n_steps * devices)
        coll_per_step = prof['collective_total_us'] / (n_steps * devices)
        summary['device_us_per_step'] = round(per_step, 3)
        summary['collective_us_per_step'] = round(coll_per_step, 3)
        summary['collective_frac'] = round(
            coll_per_step / per_step, 4) if per_step else 0.0
        from . import set_gauge as _gauge
        _gauge(f'profile.{self.name}.device_us_per_step',
               summary['device_us_per_step'])
        _gauge(f'profile.{self.name}.collective_us_per_step',
               summary['collective_us_per_step'])
        _gauge(f'profile.{self.name}.collective_frac',
               summary['collective_frac'])
        # no HLO census to join against (see the module docstring)
        summary['collective_observed'] = 0

    @property
    def observed(self):
        """collective_observed rows: none in the port."""
        return []


def step_profiler(profile=None, base_dir=None, name='train', **kw):
    """A StepProfiler for a loop, or None when profiling is off —
    loops guard with ``if prof is not None``.  ``profile=`` semantics
    are :func:`resolve_schedule`'s; under the telemetry hard kill
    switch (``PADDLE_TPU_TELEMETRY=0``) profiling is off too."""
    if _rec.hard_off():
        return None
    sched = resolve_schedule(profile)
    if sched is None:
        return None
    if base_dir is None and sched.dir is None:
        from . import flight_dir
        base_dir = flight_dir()
    return StepProfiler(sched, base_dir=base_dir, name=name, **kw)


@contextlib.contextmanager
def capture(trace_dir, name='capture', num_partitions=None, steps=1,
            sync=None):
    """One-shot capture: trace the body, then parse and emit one
    ``profile_capture`` event, yielding the profiler so the caller can
    read ``prof.windows[-1]`` afterwards.  ``steps`` is how many step
    executions the body runs (normalizes the per-step breakdown)."""
    sched = ProfileSchedule(every=1, steps=steps, start=1, limit=1,
                            dir=trace_dir)
    prof = StepProfiler(sched, base_dir=trace_dir, name=name,
                        num_partitions=num_partitions)
    prof.sync = sync
    prof._start(1)
    try:
        yield prof
    finally:
        prof.close(sync=getattr(prof, 'sync', None))
