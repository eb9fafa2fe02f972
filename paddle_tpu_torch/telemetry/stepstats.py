"""Sync-free per-step telemetry: StepAccumulator + StepTimer (the
port's copy of ``paddle_tpu/telemetry/stepstats.py``).

Per-step scalars are **buffered as device tensors** and read to the
host only every ``flush_interval`` steps — by flush time those tensors
are ``flush_interval`` steps old and long since computed, so the read
does not stall the stream busy with the *current* steps.  The
host-side step duration (``perf_counter`` deltas) rides along for
free: it never touches the device at all.

``StepTimer`` feeds the telemetry recorder's step-time reservoir so
flight dumps and run reports see timings from every entry point.  Its
``stop(sync=...)`` waits for the device where the reference calls
``jax.block_until_ready``: on a ``torch.cuda.Event`` (its
``synchronize()``), on a CUDA tensor's device or, for ``sync=True``,
the current device (``torch.cuda.synchronize``).  Without ``sync`` it
never waits.
"""
import time

from .recorder import get_recorder, hard_off

__all__ = ['StepAccumulator', 'StepTimer', 'percentiles']

_MONO = time.perf_counter


def _host(v):
    """One buffered cell as a numpy array: a torch tensor is read to
    the host (the flush's one read), anything else goes through
    ``np.asarray``."""
    import numpy as np
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def _wait(sync):
    """Block until the device work behind ``sync`` is done."""
    import torch
    if sync is True:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif isinstance(sync, torch.cuda.Event):
        sync.synchronize()
    elif isinstance(sync, torch.Tensor) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)


def percentiles(times_s):
    """Summary stats for a list of per-step durations in SECONDS;
    all outputs in milliseconds (the unit step times are read in)."""
    if not times_s:
        return {}
    ts = sorted(times_s)
    n = len(ts)

    def pct(q):
        return ts[min(n - 1, int(n * q))] * 1000.0

    return {'steps': n,
            'mean_ms': sum(ts) / n * 1000.0,
            'p50_ms': pct(0.50),
            'p90_ms': pct(0.90),
            'p99_ms': pct(0.99),
            'max_ms': ts[-1] * 1000.0}


class StepAccumulator:
    """Buffer per-step scalars as device arrays; flush to host every
    ``flush_interval`` steps.

        acc = telemetry.step_accumulator('train')   # None if disabled
        ...
        acc.observe(step=i, step_time_s=dt, wait_s=w, loss=loss)

    ``observe`` does ZERO device reads — device scalars are appended
    verbatim.  ``flush`` (every interval, and once at loop end)
    materializes the buffered columns, emits one ``steps`` event with
    the per-step arrays (step ids, step_time_ms, wait_ms, plus every
    scalar column), and feeds the recorder's step-time reservoir for
    percentile summaries.
    """

    def __init__(self, tag='train', flush_interval=None, recorder=None):
        self.rec = recorder or get_recorder()
        self.tag = tag
        self.flush_interval = max(1, int(
            flush_interval if flush_interval is not None
            else self.rec.flush_interval))
        self._steps = []
        self._times = []
        self._waits = []
        self._scalars = []      # list of {name: device-or-py scalar}
        self._spans = []        # steps each buffered row covers (K>=1)

    def __len__(self):
        return sum(self._spans)

    def observe(self, step=None, step_time_s=None, wait_s=None,
                **scalars):
        """Record one step.  `scalars` values may be device tensors
        (kept lazy) or plain numbers; None values are dropped."""
        self._steps.append(step if step is not None
                           else (self._steps[-1] + self._spans[-1]
                                 if self._steps else 0))
        self._times.append(step_time_s)
        self._waits.append(wait_s)
        self._scalars.append(
            {k: v for k, v in scalars.items() if v is not None})
        self._spans.append(1)
        if len(self) >= self.flush_interval:
            self.flush()

    def observe_chunk(self, step_lo, n, step_time_s=None, wait_s=None,
                      **scalars):
        """Record one fused K-step chunk (core.scan_loop): `scalars`
        values may be K-length stacked DEVICE arrays — kept lazy, like
        observe(), and expanded to per-step rows at flush so run_report
        percentiles stay per-step, not per-chunk.  ``step_time_s`` is
        the chunk's wall time (divided evenly across its steps at
        flush); ``wait_s`` is the chunk's staging wait (attributed to
        the chunk's first step)."""
        n = max(1, int(n))
        self._steps.append(step_lo if step_lo is not None
                           else (self._steps[-1] + self._spans[-1]
                                 if self._steps else 0))
        self._times.append(step_time_s)
        self._waits.append(wait_s)
        self._scalars.append(
            {k: v for k, v in scalars.items() if v is not None})
        self._spans.append(n)
        if len(self) >= self.flush_interval:
            self.flush()

    @staticmethod
    def _expand_scalar(v, n):
        """One buffered scalar cell -> n per-step floats (or Nones).
        The chunk-flush path tolerates K-length stacked tensors: a
        device tensor of size n contributes one float per step; a plain
        scalar broadcasts."""
        try:
            a = _host(v)
            if a.size == n:
                return [float(x) for x in a.reshape(-1)]
            if a.size == 1:
                return [float(a.reshape(()))] * n
        except (TypeError, ValueError):
            pass
        return [None] * n

    def _expand_rows(self, steps, times, waits, rows, spans):
        """Buffered (possibly chunked) rows -> flat per-step columns."""
        f_steps, f_times, f_waits, f_rows = [], [], [], []
        for step, t, w, row, n in zip(steps, times, waits, rows, spans):
            base = step if step is not None else 0
            for j in range(n):
                f_steps.append(base + j)
                f_times.append(t / n if t is not None else None)
                f_waits.append(w if j == 0 else None)
            expanded = {k: self._expand_scalar(v, n)
                        for k, v in row.items()}
            for j in range(n):
                f_rows.append({k: vs[j] for k, vs in expanded.items()
                               if vs[j] is not None})
        return f_steps, f_times, f_waits, f_rows

    def flush(self):
        """Materialize the buffer (the one host read per interval) and
        emit a ``steps`` event.  Safe to call with an empty buffer."""
        if not self._steps:
            return None
        steps, times, waits, rows = self._expand_rows(
            self._steps, self._times, self._waits, self._scalars,
            self._spans)
        (self._steps, self._times, self._waits, self._scalars,
         self._spans) = [], [], [], [], []
        cols = {}
        for i, row in enumerate(rows):
            for k, v in row.items():
                try:
                    fv = float(_host(v))
                except (TypeError, ValueError):
                    continue
                cols.setdefault(k, [None] * len(rows))[i] = fv
        ev = {'tag': self.tag, 'n': len(steps),
              'step_lo': steps[0], 'step_hi': steps[-1],
              'step': list(steps)}
        t_ms = [round(t * 1000.0, 4) for t in times if t is not None]
        if t_ms:
            ev['step_time_ms'] = [
                round(t * 1000.0, 4) if t is not None else None
                for t in times]
            for t in times:
                if t is not None:
                    self.rec.observe_step_time(t, tag=self.tag)
        w_ms = [w for w in waits if w is not None]
        if w_ms:
            ev['wait_ms'] = [
                round(w * 1000.0, 4) if w is not None else None
                for w in waits]
            self.rec.add('io.host_wait_s', sum(w_ms))
        ev.update(cols)
        self.rec.add('steps.count', len(steps))
        return self.rec.event('steps', **ev)


class StepTimer:
    """Rolling step-time statistics for training loops.

    Waits on `sync` targets (a CUDA event, a device tensor, or True for
    the current device) so timings reflect device completion, not
    dispatch; without one it times the host.  Unless ``record=False``, every stop()
    also lands in the telemetry recorder's step-time reservoir so the
    flight dump / run report summarize timings from ad-hoc profiling
    loops too."""

    def __init__(self, window=50, record=True, tag='steptimer'):
        self.window = window
        self.tag = tag
        self._record = bool(record) and not hard_off()
        self._times = []
        self._t0 = None

    def start(self):
        self._t0 = _MONO()

    def stop(self, sync=None):
        if sync is not None:
            _wait(sync)
        dt = _MONO() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        if self._record:
            get_recorder().observe_step_time(dt, tag=self.tag)
        return dt

    @property
    def mean_ms(self):
        if not self._times:
            return 0.0
        return sum(self._times) / len(self._times) * 1000.0

    def summary(self):
        if not self._times:
            return {}
        s = percentiles(self._times)
        # historical key set (profiler.StepTimer callers)
        return {'mean_ms': s['mean_ms'], 'p50_ms': s['p50_ms'],
                'p90_ms': s['p90_ms'], 'max_ms': s['max_ms'],
                'steps': s['steps']}
