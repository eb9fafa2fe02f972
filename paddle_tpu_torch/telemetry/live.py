"""Live observability plane: rolling-window aggregation of the event
stream, readable while the run is still running (the port's copy of
``paddle_tpu/telemetry/live.py``: the same windows, percentiles and
Prometheus text from the same records).

Everything before this module was post-mortem: JSONL streams merged by
``tools/run_report.py`` after the fact.  :class:`LiveAggregator`
subscribes to the SAME boundary-rate Recorder stream the exporters
consume (``Recorder.subscribe`` — no new sync points, no per-step host
work, nothing touches a device array) and maintains:

* **sliding-window percentiles** — TTFT / TPOT (from ``serve_request``
  events), serving-intervention time (``serve_step.dur_s``) and
  train-step time (``steps`` flushes), over a wall-clock window
  (default 60s) so the numbers describe *now*, not the whole run;
* **rate-derived counters** — decoded tokens/s, admissions,
  evictions *by cause*, preemptions, and compile events in steady
  state (a compile after ``mark_steady()`` is a bucket-set leak —
  the drift monitor turns it into a ``drift_detected`` event);
* **live gauges** — KV-pool block occupancy, queue depth, active
  lanes, free blocks: the last ``serve_step``'s snapshot fields;
* a bounded **per-request trace store** — ``serve_trace`` events
  (one per finished request, the whole queued→prefill→decode→finish
  lifecycle) keyed by rid for the ``/requests/<rid>`` HTTP view,
  plus a live-trace hook an attached engine provides for requests
  still in flight;
* recent **alerts** — ``slo_breach`` / ``drift_detected`` events from
  ``telemetry.monitors``, surfaced in ``/status.json``.

Consumers: :class:`telemetry.httpd.MetricsServer` renders
``snapshot()`` as ``/status.json`` and ``prometheus()`` as
``/metrics``; ``telemetry.monitors`` attaches SLO/drift monitors that
observe the same routed records.  The aggregator itself emits nothing
and syncs nothing — attaching it to a training loop is free (proven by
the transfer-guard test and ``bench.py --obs-smoke``).

Thread-safety: one RLock around all state; the HTTP server's scrape
threads read snapshots while the engine thread routes events.  A
monitor emitting an alert from inside ``write()`` re-enters the
recorder → subscriber path; the RLock plus kind-routing (alert kinds
only land in the alert ring) keeps that re-entrancy shallow and
deadlock-free.
"""
import threading
import time
from collections import OrderedDict, deque

from .recorder import get_recorder

__all__ = ['RollingWindow', 'RateCounter', 'LiveAggregator']

_MONO = time.monotonic


class RollingWindow:
    """Wall-clock-bounded sample reservoir: percentiles over the last
    ``window_s`` seconds (bounded at ``cap`` samples either way)."""

    def __init__(self, window_s=60.0, cap=4096):
        self.window_s = float(window_s)
        self._samples = deque(maxlen=int(cap))   # (t_mono, value)

    def add(self, value, now=None):
        if value is None:
            return
        self._samples.append(
            (now if now is not None else _MONO(), float(value)))

    def _evict(self, now):
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def values(self, now=None):
        self._evict(now if now is not None else _MONO())
        return [v for _, v in self._samples]

    def percentiles(self, now=None):
        """{count, mean, p50, p90, p99, max} or {} when empty."""
        vals = sorted(self.values(now))
        if not vals:
            return {}
        n = len(vals)

        def pct(q):
            return vals[min(n - 1, int(n * q))]

        return {'count': n, 'mean': sum(vals) / n,
                'p50': pct(0.50), 'p90': pct(0.90), 'p99': pct(0.99),
                'max': vals[-1]}


class RateCounter:
    """Monotonic total plus an events-per-second rate over the rolling
    window (increments timestamped, old ones evicted on read)."""

    def __init__(self, window_s=60.0, cap=4096):
        self.window_s = float(window_s)
        self.total = 0.0
        self._t0 = _MONO()
        self._incs = deque(maxlen=int(cap))      # (t_mono, n)

    def add(self, n=1, now=None):
        if not n:
            return
        self.total += n
        self._incs.append((now if now is not None else _MONO(),
                           float(n)))

    def rate(self, now=None):
        """Increments per second over the window (0.0 when idle)."""
        now = now if now is not None else _MONO()
        cutoff = now - self.window_s
        while self._incs and self._incs[0][0] < cutoff:
            self._incs.popleft()
        if not self._incs:
            return 0.0
        # divide by the full window once it has elapsed, by the
        # counter's age before that (a 5s-old run is not averaged
        # down over 60s of nonexistent history, and one fresh
        # increment cannot divide by a near-zero span)
        span = min(self.window_s, max(1e-3, now - self._t0))
        return sum(n for _, n in self._incs) / span

    def windowed(self, now=None):
        """Sum of increments inside the window."""
        now = now if now is not None else _MONO()
        cutoff = now - self.window_s
        while self._incs and self._incs[0][0] < cutoff:
            self._incs.popleft()
        return sum(n for _, n in self._incs)


class LiveAggregator:
    """The live rolling view over one process's telemetry stream.

        agg = LiveAggregator().install()
        ...run...
        agg.snapshot()          # /status.json
        agg.prometheus()        # /metrics text
        agg.uninstall()

    ``install()`` subscribes to the process-global Recorder;
    ``write(rec)`` is also a valid exporter-shaped entry point so the
    aggregator can sit in a TeeWriter if a caller prefers.  Attached
    monitors (``telemetry.monitors``) observe every routed record
    after the aggregator's own state update.
    """

    def __init__(self, window_s=60.0, max_traces=256, max_alerts=64):
        self.window_s = float(window_s)
        self._lock = threading.RLock()
        # write() is a subscriber callback — it runs on whatever
        # thread emits (trainer, serving engine, supervisor worker)
        # while scrape threads call snapshot(); every mutable field
        # below is therefore guarded by _lock.
        self._recorder = None           # guarded-by: _lock
        self._t0 = _MONO()
        self.monitors = []              # guarded-by: _lock
        self._in_write = threading.local()
        # serving latency windows (seconds)
        self.ttft = RollingWindow(window_s)          # guarded-by: _lock
        self.tpot = RollingWindow(window_s)          # guarded-by: _lock
        self.intervention_s = RollingWindow(window_s)  # guarded-by: _lock
        self.step_ms = {}  # loop tag -> RollingWindow  # guarded-by: _lock
        # rates / totals.  Tokens are two MONOTONIC counters (emitted
        # and preemption-discarded) rather than one net counter: the
        # Prometheus families must never decrease (a dropping counter
        # reads as a reset and corrupts rate() queries), while the
        # delivered figure (emitted - discarded) stays exact.
        self.tokens_emitted = RateCounter(window_s)    # guarded-by: _lock
        self.tokens_discarded = RateCounter(window_s)  # guarded-by: _lock
        self.admitted = RateCounter(window_s)          # guarded-by: _lock
        self.finished = RateCounter(window_s)          # guarded-by: _lock
        self.preempted = RateCounter(window_s)         # guarded-by: _lock
        self.compiles = RateCounter(window_s)          # guarded-by: _lock
        self.by_cause = {}  # finish cause -> RateCounter  # guarded-by: _lock
        self.requests_seen = 0          # guarded-by: _lock
        self.steady_since = None  # mono ts of mark_steady()  # guarded-by: _lock
        self.compiles_after_steady = 0  # guarded-by: _lock
        # live gauges (last serve_step snapshot)
        self.gauges = {}                # guarded-by: _lock
        self._last_serve_step_t = None  # guarded-by: _lock
        # bounded stores
        self._traces = OrderedDict()  # rid -> trace rows (LRU)  # guarded-by: _lock
        self._max_traces = int(max_traces)
        self.alerts = deque(maxlen=int(max_alerts))    # guarded-by: _lock
        self.live_trace_fn = None  # engine hook: rid -> rows|None  # guarded-by: _lock

    # -- lifecycle -----------------------------------------------------------
    def install(self, recorder=None):
        """Subscribe to the (given or global) Recorder's stream."""
        rec = recorder or get_recorder()
        # claim the slot under _lock: an unlocked check-then-act here
        # let two install() racers both subscribe, double-counting
        # every event thereafter
        with self._lock:
            if self._recorder is not None:
                return self
            self._recorder = rec
        rec.subscribe(self.write)
        return self

    def uninstall(self):
        with self._lock:
            rec, self._recorder = self._recorder, None
        if rec is not None:
            rec.unsubscribe(self.write)
        return self

    def attach_monitor(self, monitor):
        with self._lock:
            self.monitors.append(monitor)
        return monitor

    def mark_steady(self, now=None):
        """Declare warmup over: compiles from here on are anomalies
        (the drift monitor's post-warmup compile detector keys off
        this, and ``compiles_after_steady`` counts them)."""
        with self._lock:
            self.steady_since = now if now is not None else _MONO()

    # -- stream consumption ---------------------------------------------------
    def write(self, rec):
        """Route one event record (exporter-shaped entry point)."""
        if getattr(self._in_write, 'depth', 0) > 2:
            return          # a monitor's alert re-entered; stop here
        self._in_write.depth = getattr(self._in_write, 'depth', 0) + 1
        try:
            kind = rec.get('kind')
            now = _MONO()
            # monitors run UNDER the lock too: they read (and, via
            # window eviction, mutate) the same deques a scrape
            # thread's snapshot() iterates — the RLock keeps their
            # re-entrant alert emission on this thread legal while
            # excluding concurrent readers
            with self._lock:
                handler = self._HANDLERS.get(kind)
                if handler is not None:
                    handler(self, rec, now)
                for m in self.monitors:
                    try:
                        m.observe(rec, self)
                    except Exception:
                        pass    # a monitor must never block the run
        finally:
            self._in_write.depth -= 1

    def close(self):                # writer-protocol compatibility
        self.uninstall()

    # per-kind state updates (called under self._lock)
    def _on_serve_step(self, rec, now):  # locked-by: _lock
        dur = rec.get('dur_s')
        if dur is not None:
            self.intervention_s.add(dur, now)
        # decoded span tokens + the prefill first tokens this event
        # carries forward; discarded (preemption rollback) tracked
        # separately so delivered = emitted - discarded matches the
        # engine's accounting without any counter ever decreasing
        self.tokens_emitted.add((rec.get('decoded') or 0)
                                + (rec.get('prefilled') or 0), now)
        self.tokens_discarded.add(rec.get('discarded') or 0, now)
        self.admitted.add(rec.get('admitted') or 0, now)
        self.preempted.add(rec.get('preempted') or 0, now)
        for k in ('live', 'batch', 'span', 'queued', 'free_blocks',
                  'total_blocks', 'intervention', 'kv_frag_frac',
                  'kv_largest_free_run', 'kv_high_water'):
            if rec.get(k) is not None:
                self.gauges[k] = rec[k]
        free = rec.get('free_blocks')
        total = rec.get('total_blocks')
        if free is not None and total:
            # usable pool excludes the reserved trash block
            usable = max(1, total - 1)
            self.gauges['kv_occupancy'] = round(
                (usable - free) / usable, 4)
        self._last_serve_step_t = now

    def _on_serve_request(self, rec, now):  # locked-by: _lock
        self.requests_seen += 1
        self.finished.add(1, now)
        self.ttft.add(rec.get('ttft_s'), now)
        self.tpot.add(rec.get('tpot_s'), now)
        reason = rec.get('reason') or '?'
        self.by_cause.setdefault(
            reason, RateCounter(self.window_s)).add(1, now)

    def _on_serve_trace(self, rec, now):  # locked-by: _lock
        rid = rec.get('rid')
        if rid is None:
            return
        self._traces[rid] = rec.get('trace') or []
        self._traces.move_to_end(rid)
        while len(self._traces) > self._max_traces:
            self._traces.popitem(last=False)

    def _on_steps(self, rec, now):  # locked-by: _lock
        tag = rec.get('tag', 'train')
        win = self.step_ms.setdefault(tag, RollingWindow(self.window_s))
        for t in rec.get('step_time_ms') or ():
            if t is not None:
                win.add(t, now)

    def _on_compile(self, rec, now):  # locked-by: _lock
        self.compiles.add(1, now)
        if self.steady_since is not None:
            self.compiles_after_steady += 1

    def _on_alert(self, rec, now):  # locked-by: _lock
        self.alerts.append(dict(rec))

    _HANDLERS = {
        'serve_step': _on_serve_step,
        'serve_request': _on_serve_request,
        'serve_trace': _on_serve_trace,
        'steps': _on_steps,
        'compile': _on_compile,
        'slo_breach': _on_alert,
        'drift_detected': _on_alert,
        # cluster-plane edges (telemetry.cluster monitors) belong in
        # the same alert ring /status.json surfaces
        'straggler_suspect': _on_alert,
        'rank_divergence': _on_alert,
        # the memory observatory's actuation edge (MemoryMonitor)
        'memory_pressure': _on_alert,
    }

    # -- reads ---------------------------------------------------------------
    def request_trace(self, rid):
        """The stored (finished) trace for `rid`, or — via the engine
        hook — the live one; None when unknown."""
        with self._lock:
            rows = self._traces.get(rid)
            live_fn = self.live_trace_fn
        if rows is not None:
            return {'rid': rid, 'state': 'finished', 'trace': rows}
        if live_fn is not None:
            try:
                live = live_fn(rid)
            except Exception:
                live = None
            if live is not None:
                return {'rid': rid, 'state': 'live', 'trace': live}
        return None

    def snapshot(self, now=None):
        """The /status.json document: every window summarized at one
        instant.  Plain dict of plain scalars — json.dumps-able."""
        now = now if now is not None else _MONO()
        with self._lock:
            def ms(p):
                return {k: (round(v * 1000.0, 3)
                            if k != 'count' else v)
                        for k, v in p.items()}

            doc = {
                'uptime_s': round(now - self._t0, 3),
                'window_s': self.window_s,
                'serving': {
                    'ttft_ms': ms(self.ttft.percentiles(now)),
                    'tpot_ms': ms(self.tpot.percentiles(now)),
                    'intervention_ms': ms(
                        self.intervention_s.percentiles(now)),
                    'tokens_per_s': round(
                        self.tokens_emitted.rate(now)
                        - self.tokens_discarded.rate(now), 3),
                    'decoded_tokens': int(self.tokens_emitted.total
                                          - self.tokens_discarded.total),
                    'tokens_emitted': int(self.tokens_emitted.total),
                    'tokens_discarded': int(
                        self.tokens_discarded.total),
                    'requests_finished': self.requests_seen,
                    'admitted': int(self.admitted.total),
                    'admit_rate': round(self.admitted.rate(now), 3),
                    'preempted': int(self.preempted.total),
                    # ALL finish causes; 'eos'/'max_tokens' are clean
                    # completions, everything else is an eviction
                    'finished_by_cause': {
                        c: int(r.total)
                        for c, r in sorted(self.by_cause.items())},
                    'gauges': dict(self.gauges),
                },
                'steps': {tag: {k: round(v, 3) if k != 'count' else v
                                for k, v in
                                win.percentiles(now).items()}
                          for tag, win in self.step_ms.items()},
                'compiles': {
                    'total': int(self.compiles.total),
                    'steady': self.steady_since is not None,
                    'after_steady': self.compiles_after_steady,
                },
                'alerts': [dict(a) for a in self.alerts],
                'traced_requests': list(self._traces),
            }
        return doc

    def prometheus(self, now=None):
        """The /metrics document: Prometheus text exposition format
        (one HELP/TYPE pair per family, ``paddle_tpu_`` prefix)."""
        now = now if now is not None else _MONO()
        snap = self.snapshot(now)
        out = []

        def esc(v):
            # exposition-format label escaping: a caller-chosen loop
            # tag containing " \ or a newline must not invalidate the
            # whole scrape
            return str(v).replace('\\', r'\\').replace('"', r'\"') \
                .replace('\n', r'\n')

        def fam(name, mtype, help_, rows):
            emitted = False
            for labels, value in rows:
                if value is None:
                    continue
                if not emitted:
                    out.append(f'# HELP paddle_tpu_{name} {help_}')
                    out.append(f'# TYPE paddle_tpu_{name} {mtype}')
                    emitted = True
                lbl = ('{' + ','.join(f'{k}="{esc(v)}"' for k, v in
                                      sorted(labels.items())) + '}'
                       ) if labels else ''
                out.append(f'paddle_tpu_{name}{lbl} {value}')

        srv = snap['serving']
        for metric, help_ in (('ttft_ms', 'time to first token (ms), '
                                          'rolling window'),
                              ('tpot_ms', 'time per output token (ms), '
                                          'rolling window'),
                              ('intervention_ms',
                               'serving intervention wall time (ms), '
                               'rolling window')):
            pct = srv[metric]
            fam(f'serve_{metric}', 'gauge', help_,
                [({'quantile': q}, pct.get(q))
                 for q in ('p50', 'p90', 'p99')]
                + [({'quantile': 'mean'}, pct.get('mean'))])
        fam('serve_tokens_per_s', 'gauge',
            'delivered tokens per second, rolling window',
            [({}, srv['tokens_per_s'])])
        fam('serve_tokens_emitted_total', 'counter',
            'tokens emitted since engine start (monotonic)',
            [({}, srv['tokens_emitted'])])
        fam('serve_tokens_discarded_total', 'counter',
            'preemption-discarded tokens since engine start '
            '(monotonic; delivered = emitted - discarded)',
            [({}, srv['tokens_discarded'])])
        fam('serve_delivered_tokens', 'gauge',
            'delivered tokens since engine start '
            '(emitted - discarded)',
            [({}, srv['decoded_tokens'])])
        fam('serve_requests_finished_total', 'counter',
            'requests finished (any cause)',
            [({}, srv['requests_finished'])])
        fam('serve_admitted_total', 'counter', 'requests admitted',
            [({}, srv['admitted'])])
        fam('serve_preempted_total', 'counter',
            'pool-pressure preemptions', [({}, srv['preempted'])])
        fam('serve_finished_total', 'counter',
            'finished requests by cause (incl. clean completions)',
            [({'cause': c}, n)
             for c, n in srv['finished_by_cause'].items()])
        fam('serve_evictions_total', 'counter',
            'EVICTED requests by cause (clean eos/max_tokens '
            'completions excluded — alertable)',
            [({'cause': c}, n)
             for c, n in srv['finished_by_cause'].items()
             if c not in ('eos', 'max_tokens')])
        g = srv['gauges']
        fam('serve_kv_occupancy', 'gauge',
            'KV pool block occupancy fraction (0-1)',
            [({}, g.get('kv_occupancy'))])
        fam('serve_free_blocks', 'gauge', 'free KV pool blocks',
            [({}, g.get('free_blocks'))])
        fam('serve_kv_frag_frac', 'gauge',
            'KV pool fragmentation (1 - largest free run / free)',
            [({}, g.get('kv_frag_frac'))])
        fam('serve_kv_largest_free_run', 'gauge',
            'largest contiguous free KV block run',
            [({}, g.get('kv_largest_free_run'))])
        fam('serve_kv_high_water_blocks', 'gauge',
            'lifetime peak of simultaneously owned KV blocks',
            [({}, g.get('kv_high_water'))])
        fam('serve_queue_depth', 'gauge', 'queued requests',
            [({}, g.get('queued'))])
        fam('serve_active_lanes', 'gauge', 'live decode lanes',
            [({}, g.get('live'))])
        fam('serve_batch_bucket', 'gauge',
            'current padded decode batch bucket',
            [({}, g.get('batch'))])
        for tag, pct in snap['steps'].items():
            fam('step_time_ms', 'gauge',
                'host step time (ms), rolling window',
                [({'loop': tag, 'quantile': q}, pct.get(q))
                 for q in ('p50', 'p90', 'p99')])
        fam('compiles_total', 'counter', 'compile events observed',
            [({}, snap['compiles']['total'])])
        fam('compiles_after_steady_total', 'counter',
            'compiles after the run was declared steady',
            [({}, snap['compiles']['after_steady'])])
        alerts = {}
        for a in snap['alerts']:
            alerts[a.get('kind', '?')] = \
                alerts.get(a.get('kind', '?'), 0) + 1
        fam('alerts_total', 'counter',
            'slo_breach / drift_detected alerts in the ring',
            [({'kind': k}, n) for k, n in sorted(alerts.items())])
        fam('uptime_seconds', 'gauge', 'aggregator uptime',
            [({}, snap['uptime_s'])])
        return '\n'.join(out) + '\n'
