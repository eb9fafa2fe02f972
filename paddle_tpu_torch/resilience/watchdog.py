"""Straggler and hang supervision for one rank (the port's copy of
``paddle_tpu/resilience/watchdog.py``).

* **Budget** — per-step and per-collective deadline budgets, with the
  serving derivations the engine and the SLO monitor read
  (``request_budget_s``, ``ttft_budget_s``); defaults derive from a
  cost estimate x a slack factor (``Budget.from_costmodel``) or from
  measured step times (``note_measured``); the ``PADDLE_TPU_WATCHDOG``
  env (``1`` or ``step=30,collective=5,slack=8``) configures it
  fleet-wide.  Off unless explicitly enabled —
  ``ParallelTrainer(watchdog=True)``, ``ServeConfig(watchdog=True)``
  or the env.
* **collective_budget** — a thread-local deadline scope for bounded
  waits; ``remaining_budget`` reads it.
* **Watchdog** — the daemon thread that supervises one step loop: the
  step deadline (``step_started``/``step_finished``, plain attribute
  writes on the step path), the soft ``straggler`` note, a flight dump
  at escalation, and then ``on_escalate(info)`` or, by default, an exit
  with ``WATCHDOG_EXIT_CODE`` after ``budget.grace_s`` so the elastic
  supervisor restarts the rank.  ``heartbeat_file=`` (the port's
  addition for one rank without a cluster store) makes the thread
  publish ``{ts, step, rank, budget_s, budget_source}`` there every
  ``heartbeat_interval`` while the current step is inside its deadline,
  so a hung step lets the file go stale for the supervisor's
  staleness check.

The cluster half — ``transport=``/``kv=``, the peers' heartbeats over
the key-value store, the quorum and the coordinated abort — needs
``distributed/collective.py``'s ``HostCollectives`` and raises
``NotImplementedError`` until that host transport lands (ROADMAP Queue
1 item 9b, second part).
"""
import contextlib
import json
import os
import threading
import time

__all__ = ['WATCHDOG_EXIT_CODE', 'WATCHDOG_ENV', 'Budget', 'Watchdog',
           'collective_budget', 'remaining_budget', 'resolve_watchdog',
           'default_collective_s']

# distinct from PREEMPTED_EXIT_CODE (117, free restart): a watchdog
# kill IS a failure — a hung rank must cost one restart from the
# budget, or a deterministic hang restarts forever
WATCHDOG_EXIT_CODE = int(os.environ.get(
    'PADDLE_TPU_WATCHDOG_EXIT_CODE', '121'))
WATCHDOG_ENV = 'PADDLE_TPU_WATCHDOG'


class Budget:
    """Deadline budgets for one supervised loop.

    step_s        wall-clock allowance for one host-loop step (dispatch
                  to dispatch).  None -> default_step_s.
                  Under a FUSED K-step loop (core.scan_loop) one
                  host-visible "step" is a whole K-chunk: the trainer
                  passes ``step_started(budget_s=K x step_s)`` so the
                  budget covers the chunk, and — when an explicit
                  step_s was armed together with a cost-model step
                  estimate — K itself clamps so a hung chunk is still
                  detected inside the armed deadline
                  (``scan_loop.clamp_chunk`` /
                  ``ParallelTrainer.fused_chunk_len``).
    collective_s  allowance for one host collective's wait.
    slack         multiplier applied to cost-model estimates when
                  deriving budgets (estimates are ideal-wire numbers;
                  real steps pay host work, stragglers, fs jitter).
    first_step_s  allowance for the first step (compile rides on it).
    straggler_frac  fraction of step_s after which a still-running
                  step emits a ``straggler`` event (soft warning
                  before the hard timeout).
    """

    def __init__(self, step_s=None, collective_s=None, slack=8.0,
                 first_step_s=None, straggler_frac=0.5,
                 default_step_s=60.0, grace_s=5.0):
        self.step_s = None if step_s is None else float(step_s)
        self.collective_s = (None if collective_s is None
                             else float(collective_s))
        self.slack = float(slack)
        self.first_step_s = (None if first_step_s is None
                             else float(first_step_s))
        self.straggler_frac = float(straggler_frac)
        self.default_step_s = float(default_step_s)
        self.grace_s = float(grace_s)
        # where step_s came from — the adaptation ladder: an operator's
        # EXPLICIT deadline is never overridden; the analytic
        # cost-model estimate and the global default both yield to a
        # MEASURED rolling profile once one exists (note_measured)
        self.step_source = ('explicit' if step_s is not None
                            else 'default')

    def effective_step_s(self):
        return self.step_s if self.step_s is not None \
            else self.default_step_s

    def effective_first_step_s(self):
        if self.first_step_s is not None:
            return self.first_step_s
        # compile dominates the first step; be generous but bounded
        return max(120.0, 4 * self.effective_step_s())

    # -- serving SLO derivations (telemetry.monitors / serving) -----------
    def ttft_budget_s(self):
        """The aggregate TTFT allowance the serving SLO monitor
        compares its rolling p99 against: queueing + prefill ride on
        the first-step allowance, exactly like the per-request
        deadline derivation — one budget machinery, two consumers."""
        return self.effective_first_step_s()

    def request_budget_s(self, max_new_tokens, span=1):
        """Per-request completion allowance: first-step (prefill +
        compile headroom) plus one step allowance per fused decode
        span.  ``ServingEngine.request_deadline_s`` derives per-request
        deadlines from this; ``SLOMonitor`` uses the same numbers as
        aggregate thresholds."""
        import math
        spans = math.ceil(max(1, int(max_new_tokens) - 1)
                          / max(1, int(span)))
        return self.effective_first_step_s() \
            + spans * self.effective_step_s()

    @classmethod
    def from_costmodel(cls, est_step_us, slack=8.0, min_step_s=5.0,
                       **kwargs):
        """Derive the step budget from a cost-model estimate (the
        planner's ``est_us + compute_us``, or a census total): budget =
        max(min_step_s, est * slack).  The estimate is a lower bound on
        device time; the slack covers host work and real-world jitter
        while keeping the deadline proportional to the workload instead
        of one global constant."""
        step_s = max(min_step_s, float(est_step_us) * 1e-6 * slack)
        budget = cls(step_s=step_s, slack=slack, **kwargs)
        budget.step_source = 'costmodel'
        return budget

    def note_measured(self, times_s, min_samples=16, quantile=0.95,
                      min_step_s=1.0):
        """Refresh the step budget from MEASURED per-step wall times
        (the ROADMAP item-3 carry-over: budgets from rolling per-step
        profiles, not the analytic estimate).

        ``times_s`` is a window of recent host-side step durations in
        seconds.  The new budget is the window's ``quantile`` x
        ``slack`` (the same slack posture the cost-model derivation
        uses), floored at ``min_step_s``.  Only non-explicit budgets
        adapt: an operator's armed ``step=`` deadline is a contract,
        while the cost-model/default numbers are estimates the
        measured profile strictly improves on.  Returns the new step_s,
        or None when nothing changed (explicit budget, or too few
        samples)."""
        if self.step_source == 'explicit':
            return None
        ts = sorted(float(t) for t in times_s if t is not None)
        if len(ts) < int(min_samples):
            return None
        est = ts[min(len(ts) - 1, int(len(ts) * float(quantile)))]
        new = max(float(min_step_s), est * self.slack)
        self.step_s = new
        self.step_source = 'measured'
        return new

    def reset_measured(self, est_step_us=None, min_step_s=5.0):
        """Forget a MEASURED step budget after a plan swap: the new
        plan's steps share nothing with the degraded plan's p95, so
        the rolling profile must re-learn from scratch.  The budget
        drops back one rung on the adaptation ladder — to the new
        plan's cost-model estimate when one is given, else the global
        default.  Explicit budgets are a contract and never reset.
        Returns the new step_s (None = default)."""
        if self.step_source == 'explicit':
            return None
        if est_step_us:
            self.step_s = max(float(min_step_s),
                              float(est_step_us) * 1e-6 * self.slack)
            self.step_source = 'costmodel'
        else:
            self.step_s = None
            self.step_source = 'default'
        return self.step_s

    @classmethod
    def from_env(cls, text):
        """Parse the PADDLE_TPU_WATCHDOG value: '1'/'on' -> defaults;
        'step=30,collective=5,slack=8' -> explicit numbers."""
        text = (text or '').strip()
        if text.lower() in ('', '0', 'off', 'false'):
            return None
        if text.lower() in ('1', 'on', 'true'):
            return cls()
        kwargs = {}
        keymap = {'step': 'step_s', 'collective': 'collective_s',
                  'slack': 'slack', 'first': 'first_step_s',
                  'grace': 'grace_s'}
        for part in text.split(','):
            if '=' not in part:
                continue
            k, v = part.split('=', 1)
            k = keymap.get(k.strip(), None)
            if k is None:
                continue
            try:
                kwargs[k] = float(v)
            except ValueError:
                pass
        return cls(**kwargs)

    def to_dict(self):
        return {'step_s': self.step_s, 'collective_s': self.collective_s,
                'slack': self.slack, 'first_step_s': self.first_step_s}


def resolve_watchdog(arg):
    """The shared opt-in posture: explicit False -> None (off even if
    the env says on); True -> Budget(); Budget/dict pass through; None
    -> the PADDLE_TPU_WATCHDOG env decides.  Returns a Budget or
    None."""
    if arg is False:
        return None
    if arg is None:
        return Budget.from_env(os.environ.get(WATCHDOG_ENV))
    if arg is True:
        return Budget()
    if isinstance(arg, Budget):
        return arg
    if isinstance(arg, dict):
        return Budget(**arg)
    raise TypeError(f'watchdog= expects bool/dict/Budget, got {arg!r}')


# -- collective-deadline scope (retry() clamps to it) -------------------------

_budget_local = threading.local()


@contextlib.contextmanager
def collective_budget(seconds):
    """Arm a thread-local deadline for the enclosed cluster wait.  The
    host transport wraps its exchanges in this; retry(deadline=) and
    nested transport calls clamp to the REMAINING budget, so no layer
    of retrying can outlive the collective's allowance."""
    prev = getattr(_budget_local, 'deadline', None)
    mine = time.monotonic() + float(seconds)
    _budget_local.deadline = mine if prev is None else min(prev, mine)
    try:
        yield
    finally:
        _budget_local.deadline = prev


def remaining_budget():
    """Seconds left in the innermost armed collective budget, or None
    when no budget is armed.  Never negative."""
    deadline = getattr(_budget_local, 'deadline', None)
    if deadline is None:
        return None
    return max(0.0, deadline - time.monotonic())


# the per-collective allowance of the currently-started Watchdog
# (Budget.collective_s), process-global: the host transport clamps
# every exchange's wait to it, which is what makes
# PADDLE_TPU_WATCHDOG=collective=5 actually bound collectives instead
# of being parsed-and-ignored configuration
_default_collective_s = None


def default_collective_s():
    """The started Watchdog's per-collective budget in seconds, or
    None when no watchdog (or none with collective_s) is running."""
    return _default_collective_s


class Watchdog:
    """Supervise one step loop.  Use as a context manager or
    start()/stop().

    The step path stays sync-free: ``step_started``/``step_finished``
    are plain attribute writes.  All detection runs on the daemon
    thread at ``poll`` cadence.

    Escalation on a blown step deadline:
      1. ``timeout`` telemetry event, with rank and elapsed/budget
         attribution;
      2. flight-recorder dump to ``flight_dir`` (or telemetry's);
      3. ``on_escalate(info)`` — the default exits the process with
         WATCHDOG_EXIT_CODE after ``budget.grace_s``.  Tests pass
         their own callback.
    """

    def __init__(self, budget=None, name='train', rank=None, world=None,
                 transport=None, kv=None, namespace='ptpu',
                 heartbeat_interval=0.5, peer_stale_s=None,
                 on_escalate=None, flight_dir=None, poll=0.05,
                 heartbeat_file=None):
        if transport is not None or kv is not None:
            raise NotImplementedError(
                'Watchdog(transport=/kv=): the heartbeat quorum and the '
                'coordinated abort ride distributed.collective\'s '
                'HostCollectives, which is not ported yet (ROADMAP Queue '
                '1 item 9b, second part: the host transport)')
        self.budget = budget or Budget()
        self.name = name
        self.transport = None
        self.rank = 0 if rank is None else int(rank)
        self.world = 1 if world is None else int(world)
        self.heartbeat_interval = float(heartbeat_interval)
        self.peer_stale_s = (float(peer_stale_s)
                             if peer_stale_s is not None
                             else self.budget.effective_step_s())
        self.on_escalate = on_escalate
        self.flight_dir = flight_dir
        self.heartbeat_file = heartbeat_file
        self.poll = float(poll)
        self._thread = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._step_no = None
        self._step_deadline = None
        self._step_started_at = None
        self._straggler_noted = False
        self._escalated = False
        self.events = []        # local record for tests/reports

    # -- step-loop notifications (sync-free) ---------------------------------

    def step_started(self, step_no, budget_s=None, first=False):
        if budget_s is None:
            budget_s = (self.budget.effective_first_step_s() if first
                        else self.budget.effective_step_s())
        now = time.monotonic()
        with self._lock:
            self._step_no = step_no
            self._step_started_at = now
            self._step_deadline = now + budget_s
            self._straggler_noted = False

    def step_finished(self, step_no=None):
        with self._lock:
            self._step_deadline = None
            self._step_started_at = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        global _default_collective_s
        if self.budget.collective_s is not None:
            self._prev_collective_s = _default_collective_s
            _default_collective_s = self.budget.collective_s
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f'watchdog-{self.name}',
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        global _default_collective_s
        if hasattr(self, '_prev_collective_s'):
            _default_collective_s = self._prev_collective_s
            del self._prev_collective_s
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- detection loop ------------------------------------------------------

    def _loop(self):
        last_hb = 0.0
        while not self._stop.wait(self.poll):
            now = time.monotonic()
            if (self.heartbeat_file is not None
                    and now - last_hb >= self.heartbeat_interval):
                if self._publish_heartbeat(now):
                    last_hb = now
            self._check_step(now)

    def _check_step(self, now):
        with self._lock:
            deadline = self._step_deadline
            started = self._step_started_at
            step_no = self._step_no
            straggler_noted = self._straggler_noted
        if deadline is None or self._escalated:
            return
        elapsed = now - started
        budget = deadline - started
        if not straggler_noted and \
                elapsed > budget * self.budget.straggler_frac:
            with self._lock:
                self._straggler_noted = True
            self._emit('straggler', step=step_no, rank=self.rank,
                       elapsed_s=round(elapsed, 3),
                       budget_s=round(budget, 3))
        if now > deadline:
            self._escalate('timeout', step=step_no,
                           elapsed_s=round(elapsed, 3),
                           budget_s=round(budget, 3))

    def _publish_heartbeat(self, now):
        """Write the heartbeat file (atomically), unless the current
        step is past its deadline or the watchdog escalated: a hung
        rank's heartbeat must go stale.  Returns whether it wrote."""
        with self._lock:
            deadline = self._step_deadline
        if self._escalated or (deadline is not None and now > deadline):
            return False
        doc = json.dumps({'ts': time.time(), 'step': self._step_no,
                          'rank': self.rank,
                          'budget_s': round(
                              self.budget.effective_step_s(), 3),
                          'budget_source': getattr(
                              self.budget, 'step_source', None)})
        try:
            from .manifest import atomic_write
            atomic_write(self.heartbeat_file, lambda f: f.write(doc),
                         prefix='.hb_tmp')
        except OSError:
            return False
        return True

    # -- escalation ----------------------------------------------------------

    def _emit(self, kind, **data):
        self.events.append(dict(kind=kind, **data))
        try:
            from .. import telemetry
            telemetry.event(kind, name=self.name, **data)
            telemetry.add(f'watchdog.{kind}')
        except Exception:
            pass

    def _escalate(self, kind, **data):
        if self._escalated:
            return
        self._escalated = True
        info = dict(kind=kind, rank=self.rank, name=self.name, **data)
        self._emit(kind, rank=self.rank, **data)
        # durable evidence BEFORE the exit: the flight ring holds the
        # straggler/timeout trail that explains the restart
        try:
            from .. import telemetry
            d = self.flight_dir or telemetry.flight_dir()
            if d:
                path = os.path.join(
                    d, f'flightrec-watchdog-r{self.rank}-'
                       f'{self._step_no}.json')
                telemetry.dump_flight(path)
                info['flight'] = path
        except Exception:
            pass
        if self.on_escalate is not None:
            try:
                self.on_escalate(info)
            except Exception:
                pass
            return
        self._default_escalate(info)

    def _default_escalate(self, info):
        """Grace, then hard exit: os._exit is the only call guaranteed
        to free a rank wedged in native code so the elastic supervisor
        can respawn it."""
        time.sleep(self.budget.grace_s)
        os._exit(WATCHDOG_EXIT_CODE)
