"""Recorder — the process-global telemetry state (the port's copy of
``paddle_tpu/telemetry/recorder.py``: the same event vocabulary, ring,
writers and subscribers, so one run report reads both packages).

One Recorder per process holds everything the run emits:

* **events** — typed records (``compile``, ``retrace``,
  ``checkpoint_save``, ``preemption``, ``nan_rollback``,
  ``lint_finding``, ...) appended at host-side boundaries.  The most
  recent ``max_events`` live in a bounded ring — the **flight
  recorder** — that ``dump_flight()`` serializes for post-mortems
  (resilience dumps it next to the checkpoint on SIGTERM preemption,
  NaN rollback and crash).  When a JSONL writer is attached
  (``telemetry.enable``), every event additionally streams to disk.
* **counters / gauges** — cheap monotonic adds and last-value reads
  (retrace counts, dataloader wait seconds, collective bytes).
* **spans** — nested monotonic-clock timers (``span('compile')``);
  each close updates per-name aggregate stats and emits a ``span``
  event.

Emission points are boundary-rate (compile, checkpoint, epoch, flush),
never per-device-step: the per-step path lives in
``stepstats.StepAccumulator`` which buffers DEVICE scalars and reads
them back only every ``flush_interval`` steps, so telemetry never
reintroduces the host syncs the PR-2 lint work removed.

This module imports only stdlib — it must be importable from anywhere
in the package without cycles.  The rank comes from the environment
(``PADDLE_TRAINER_ID``, then ``RANK`` as ``torch.distributed``'s
launchers set it), never from a backend.
"""
import contextlib
import json
import os
import sys
import threading
import time
from collections import deque

__all__ = ['Recorder', 'get_recorder', 'reset', 'hard_off',
           'EVENT_KINDS']

# documented event vocabulary, the reference's kind for kind.  Every
# kind any module under paddle_tpu_torch/ emits MUST be declared here —
# a test greps the package's emission sites and fails on an undeclared
# kind (run_report still groups unknown kinds from third-party
# emitters into the timeline).
EVENT_KINDS = (
    'run_meta',            # enable(): argv / rank / backend
    'compile',             # a step function compiled (dur_s, variants)
    'retrace',             # a compile cache grew past 1 variant
    'checkpoint_save',     # save dispatched (step, async)
    'checkpoint_commit',   # async barrier drained + manifest committed
    'checkpoint_restore',  # restore completed (step, dur_s)
    'checkpoint_quarantine',  # torn dir moved aside
    'commit_intent',       # 2-phase commit: one host's ack landed
    'commit_finalize',     # 2-phase commit: all acks in, manifest up
    'reshape_restore',     # restore resharded onto a different
                           # mesh / process count (elastic reshape)
    'retry',               # resilience.retry re-attempted a transient
                           # failure (fn, attempt, delay_s, error)
    'restart_backoff',     # elastic supervisor delaying a crash
                           # restart (exponential backoff)
    'fault_injected',      # chaos engine injected a planned fault
                           # (seed, fault kind, step/path/op/rank)
    'timeout',             # a collective or step deadline expired
                           # (op/step, budget_s, missing ranks) —
                           # HostCollectives / watchdog emit these
    'straggler',           # a step ran past its soft threshold, or a
                           # peer's heartbeat went stale (rank/peer
                           # attribution)
    'quorum_lost',         # a majority of ranks stopped heartbeating;
                           # the watchdog escalates to abort
    'coordinated_abort',   # the cluster abort flag was raised so
                           # peers stop waiting and restart together
    'preemption',          # SIGTERM/SIGINT latched or observed
    'nan_skip',            # non-finite step skipped on device
    'nan_rollback',        # sentinel demanded a rollback
    'nan_fatal',           # rollback budget exhausted
    'lint_finding',        # analysis finding surfaced at a choke point
    'collectives',         # per-op collective byte census of one step
    'collective_cost',     # predicted wire bytes / torus time per
                           # collective (analysis.costmodel at compile)
    'collective_observed', # profiled per-collective timing from a
                           # capture window (op, wire_bytes, us,
                           # phases) — telemetry.profile emits them,
                           # calibrate_costmodel fits alpha/beta
                           # from them
    'profile_capture',     # one sampled profiler window closed
                           # (step range, trace path, device-compute
                           # vs collective breakdown, error if any)
    'plan_selected',       # auto-sharding planner chose a plan
                           # (winner mesh/assignment, predicted wire
                           # bytes/us + peak HBM, candidates scored)
    'compile_cache',       # persistent compile-cache traffic (action:
                           # hit/miss/serialize/deserialize/quarantine/
                           # warm_start; tier, bytes, dur_s, saved_s)
    'fused_clamp',         # a fused K-chunk exceeded the watchdog
                           # step budget's capacity (requested, fits)
                           # — stage fused_chunk_len() chunks instead
    'serve_step',          # one serving-engine intervention (live
                           # set size, batch bucket, span, decoded
                           # tokens, admissions/evictions/preemptions,
                           # free KV blocks) — serving/engine.py
    'serve_request',       # one serving request finished (rid,
                           # state/reason, prompt_len, tokens, TTFT,
                           # TPOT, preemptions) — deadline breaches
                           # additionally emit a 'timeout' event
    'serve_trace',         # one finished request's full lifecycle
                           # trace (rid + ordered stage rows:
                           # queued -> admitted -> prefill ->
                           # first_token -> decode_span* ->
                           # finished/evicted/preempted, each with
                           # cause and bucket tags) — joinable with
                           # serve_request by rid; telemetry.live
                           # keeps a bounded store of these for the
                           # /requests/<rid> HTTP trace view
    'serve_reject',        # admission control refused a request
                           # (rid, reason: queue_full/draining/
                           # exceeds_pool, retry_after_s, detail) —
                           # the typed load-shedding taxonomy shared
                           # by ServingEngine.submit and the serving
                           # front door (serving/scheduler.py
                           # RejectReason is the one source of truth)
    'fleet_event',         # one serving-fleet control action
                           # (action: dispatch/retry/drain/promote/
                           # replica_down/replica_up, replica, rid) —
                           # serving/router.py's control-plane trail,
                           # joinable with serve_request by rid
    'slo_breach',          # a rolling SLO monitor tripped (what:
                           # ttft_p99 over the watchdog-derived
                           # budget, or deadline-eviction rate over
                           # threshold) — telemetry.monitors emits,
                           # with observed vs budget attribution
    'drift_detected',      # predicted-vs-observed drift: windowed
                           # us_ratio from collective_observed left
                           # its band, or a compile landed after the
                           # run was declared steady — the
                           # re-planning trigger a plan_supervisor
                           # (ROADMAP item 3) consumes
    'straggler_suspect',   # the live cluster view attributed a
                           # straggler (rank + cause: compute/step
                           # skew, behind, stale frame/heartbeat) —
                           # telemetry.monitors latches it off the
                           # ClusterAggregator's joined view; distinct
                           # from the watchdog's own-step 'straggler'
    'rank_divergence',     # cross-rank loss-window spread left its
                           # band: a rank is training on different
                           # state than its peers (corrupt restore,
                           # leaked collective fault, desynced rng)
    'remediation',         # the plan supervisor resolved one incident
                           # (trigger, policy, outcome: swap/hold/
                           # backoff/degraded, with stage + error on
                           # the degrade path) — resilience.supervisor
                           # emits one per debounced incident
    'plan_swap',           # the trainer applied a supervisor-queued
                           # plan at a step/chunk boundary (from_mesh
                           # -> to_mesh, assignment, trigger, dur_s)
                           # — the observe→act loop's actuation edge
    'crash',               # the sys.excepthook crash hook latched an
                           # unhandled exception (ring-only, then the
                           # flight dump persists it)
    'steps',               # StepAccumulator flush (per-step scalars;
                           # fused chunk rows arrive expanded to
                           # per-step entries)
    'span',                # a closed span (name, dur_s)
    'scalar',              # user scalar (VisualDL / ScalarAdapter)
    'flight_dump',         # a flight-recorder dump was written
    'lockcheck',           # analysis.lockcheck disarm summary (locks
                           # wrapped, order-graph edges, cycles,
                           # unguarded accesses, worst hold time) —
                           # one per armed window
    'memory_compiled',     # one compiled module's memory: XLA's
                           # memory_analysis in the reference; in the
                           # port the graph pool bytes a CUDA graph
                           # capture took (telemetry.memory)
    'memory_sample',       # one MemorySampler tick: live device
                           # bytes (memory_stats or the host census),
                           # high-water, host RSS —
                           # boundary-rate, default OFF
                           # (PADDLE_TPU_MEMSTATS)
    'memory_pressure',     # the live high-water crossed the budget
                           # watermark (telemetry.monitors
                           # MemoryMonitor; latched exactly-once like
                           # slo_breach) — the supervisor re-plans on
                           # it with a tightened hbm budget
    'collective_mismatch',  # the collective flight recorder's
                           # cross-rank ring diff found the first
                           # divergent collective (op/seq/step +
                           # per-rank call sites) — the SPMD-contract
                           # attribution behind a CollectiveTimeout,
                           # straggler escalation, or rank_divergence
)

_WALL = time.time
_MONO = time.perf_counter


def hard_off():
    """True when PADDLE_TPU_TELEMETRY=0/off/false: every telemetry
    entry point becomes a no-op (the escape hatch for runs that cannot
    afford even boundary-rate host bookkeeping)."""
    return os.environ.get('PADDLE_TPU_TELEMETRY', '1').lower() in (
        '0', 'off', 'false')


def _rank():
    """Best-effort host rank from the environment; never raises."""
    for var in ('PADDLE_TRAINER_ID', 'RANK'):
        r = os.environ.get(var)
        if r is not None:
            try:
                return int(r)
            except ValueError:
                pass
    return 0


class Recorder:
    """Process-global telemetry sink.  Thread-safe; all methods are
    cheap enough for host-loop boundaries (one lock, dict/deque ops).
    Never raises out of an emission path — telemetry must not be able
    to kill a training run."""

    def __init__(self, max_events=2048):
        self._lock = threading.RLock()
        self._events = deque(maxlen=max_events)   # the flight ring
        self.counters = {}
        self.gauges = {}
        self.span_stats = {}    # name -> {count, total_s, max_s}
        self._writer = None     # exporters.JsonlWriter when enabled
        self._subscribers = ()  # in-process stream consumers (live.py)
        self._local = threading.local()
        self._t0_wall = _WALL()
        self._t0 = _MONO()
        self.flush_interval = 32   # StepAccumulator default
        self._step_reservoir = {}  # tag -> bounded list of step dt (s)

    # -- events --------------------------------------------------------------
    def _record(self, kind, data):
        rec = {'kind': kind,
               'ts': round(_WALL(), 6),
               't': round(_MONO() - self._t0, 6)}
        rec.update(data)
        return rec

    def event(self, kind, **data):
        """Append one typed event to the flight ring and (when a
        writer is attached) stream it to JSONL."""
        rec = self._record(kind, data)
        with self._lock:
            self._events.append(rec)
            w = self._writer
            subs = self._subscribers
        if w is not None:
            try:
                w.write(rec)
            except Exception:       # a full disk must not kill a step
                pass
        for cb in subs:
            try:
                cb(rec)
            except Exception:       # a broken consumer must not either
                pass
        return rec

    def event_unlocked(self, kind, **data):
        """Async-signal-safe event: single deque.append (atomic in
        CPython), no lock, no file I/O.  GracefulShutdown's handler
        uses this so a signal landing while another thread holds the
        recorder lock cannot deadlock the latch."""
        rec = self._record(kind, data)
        self._events.append(rec)
        return rec

    def events(self, kind=None):
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e['kind'] == kind]

    # -- counters / gauges ---------------------------------------------------
    def add(self, name, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name, value):
        with self._lock:
            self.gauges[name] = value

    # -- spans ---------------------------------------------------------------
    def _span_stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name, **attrs):
        """Nested monotonic timer.  Closing updates span_stats[name]
        and emits a ``span`` event carrying the parent span's name so
        nesting is reconstructable offline."""
        stack = self._span_stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = _MONO()
        try:
            yield self
        finally:
            dt = _MONO() - t0
            stack.pop()
            with self._lock:
                st = self.span_stats.setdefault(
                    name, {'count': 0, 'total_s': 0.0, 'max_s': 0.0})
                st['count'] += 1
                st['total_s'] += dt
                st['max_s'] = max(st['max_s'], dt)
            ev = dict(attrs)
            if parent:
                ev['parent'] = parent
            self.event('span', name=name, dur_s=round(dt, 6), **ev)

    # -- step-time reservoir -------------------------------------------------
    def observe_step_time(self, dt_s, tag='step', _cap=4096):
        """Record one host-side step duration (seconds) into the
        bounded per-tag reservoir the flight dump summarizes."""
        with self._lock:
            res = self._step_reservoir.setdefault(tag, [])
            res.append(dt_s)
            if len(res) > _cap:
                del res[:len(res) - _cap]

    def step_times(self, tag='step'):
        with self._lock:
            return list(self._step_reservoir.get(tag, []))

    # -- in-process subscribers ----------------------------------------------
    def subscribe(self, callback):
        """Register an in-process consumer of the event stream.  It
        receives exactly the records a writer would — the boundary-rate
        flushes, never anything per-step — after the ring append and
        the JSONL write, outside the recorder lock.  Exceptions are
        swallowed (consumers are observers, never blockers).  Signal-
        safe ``event_unlocked`` records do NOT notify (no user code
        may run in a signal handler's context)."""
        with self._lock:
            if callback not in self._subscribers:
                self._subscribers = self._subscribers + (callback,)
        return callback

    def unsubscribe(self, callback):
        # equality, not identity: a bound method (agg.write) is a
        # fresh object on every attribute access, but compares equal
        with self._lock:
            self._subscribers = tuple(
                cb for cb in self._subscribers if cb != callback)

    # -- writer --------------------------------------------------------------
    def attach_writer(self, writer):
        with self._lock:
            old, self._writer = self._writer, writer
        return old

    @property
    def writer(self):
        return self._writer

    # -- flight dump ---------------------------------------------------------
    def snapshot(self):
        """The flight-recorder document as a plain dict."""
        from .stepstats import percentiles
        with self._lock:
            doc = {
                'version': 1,
                'rank': _rank(),
                'pid': os.getpid(),
                'argv': list(sys.argv),
                'wall_t0': self._t0_wall,
                'counters': dict(self.counters),
                'gauges': {k: _jsonable(v)
                           for k, v in self.gauges.items()},
                'span_stats': {k: dict(v)
                               for k, v in self.span_stats.items()},
                'step_times': {tag: percentiles(ts) for tag, ts in
                               self._step_reservoir.items() if ts},
                'events': [dict(e) for e in self._events],
            }
        return doc

    def dump_flight(self, path):
        """Atomically write the flight-recorder JSON to `path`
        (tmp + rename — a crash mid-dump leaves no torn file).
        Returns the path, or None when the write failed (a dump runs
        inside preemption grace windows; it must never raise)."""
        try:
            doc = self.snapshot()
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + '.tmp'
            with open(tmp, 'w') as f:
                json.dump(doc, f, indent=1, default=_jsonable)
            os.replace(tmp, path)
            self.event('flight_dump', path=os.path.abspath(path),
                       n_events=len(doc['events']))
            return path
        except Exception:
            return None


def _jsonable(o):
    """numpy / torch scalars → plain floats for json.dump."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


# -- process-global singleton -------------------------------------------------
_recorder = None
_recorder_lock = threading.Lock()


def get_recorder():
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = Recorder()
    return _recorder


def reset():
    """Drop the global recorder (tests; a fresh run in one process).
    Any attached writer is closed first."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None and _recorder.writer is not None:
            try:
                _recorder.writer.close()
            except Exception:
                pass
        _recorder = None
