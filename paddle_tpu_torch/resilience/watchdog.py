"""Deadline budgets: the serving half of the reference's watchdog
(the port's copy of ``paddle_tpu/resilience/watchdog.py`` up to its
``Watchdog`` thread class).

* **Budget** — per-step and per-collective deadline budgets, with the
  serving derivations the engine and the SLO monitor read
  (``request_budget_s``, ``ttft_budget_s``); defaults derive from a
  cost estimate x a slack factor (``Budget.from_costmodel``) or from
  measured step times (``note_measured``); the ``PADDLE_TPU_WATCHDOG``
  env (``1`` or ``step=30,collective=5,slack=8``) configures it
  fleet-wide.  Off unless explicitly enabled —
  ``ServeConfig(watchdog=True)`` or the env.
* **collective_budget** — a thread-local deadline scope for bounded
  waits; ``remaining_budget`` reads it.

The ``Watchdog`` thread itself (the step deadline, heartbeats over the
cluster's key-value store, the timeout -> flight dump -> coordinated
abort escalation) belongs to distributed training and waits for a later
slice of the port; until then no watchdog is ever started, so
``default_collective_s()`` is None.
"""
import contextlib
import os
import threading
import time

__all__ = ['WATCHDOG_EXIT_CODE', 'WATCHDOG_ENV', 'Budget',
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
