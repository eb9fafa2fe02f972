"""Rolling SLO / drift monitors over the live telemetry stream (the
port's copy of ``paddle_tpu/telemetry/monitors.py``: the same latches
fire on the same records).

These are the *sensors* ROADMAP item 3's self-tuning runtime needs: a
``plan_supervisor`` that re-plans in flight has to be told WHEN — and
"when" is exactly the two typed events emitted here:

* ``slo_breach`` (:class:`SLOMonitor`) — the serving runtime left its
  latency envelope: rolling-window TTFT p99 over the watchdog-derived
  budget (``resilience.watchdog.Budget.ttft_budget_s`` — the same
  deadline machinery that already evicts individual starved requests,
  lifted to the aggregate), or the deadline-eviction *rate* over a
  threshold (requests are being shed, not served).
* ``drift_detected`` (:class:`DriftMonitor`) — the world stopped
  matching the model of it: the windowed observed/predicted us_ratio
  of a profiled collective (PR-8 ``collective_observed`` events carry
  both sides) left its band, or a ``compile`` event landed after the
  run was declared steady (a bucket-set leak / retrace in what should
  be a finite compiled surface).

Monitors attach to a :class:`telemetry.live.LiveAggregator`
(``agg.attach_monitor(...)``) and observe the same boundary-rate
records it routes — nothing here runs per device step or touches a
device array.  Both monitors **latch**: a sustained breach fires ONE
event, re-arming only after the signal returns inside its band (with
hysteresis), so a supervisor sees edges, not a firehose — and the
seeded drift-injection acceptance ("inflate one collective's observed
us → exactly one ``drift_detected``") holds by construction.

The TRAINING-cluster plane (the reference's ``telemetry.cluster``; the
port's waits for a later slice) reuses the same two monitors through a
second hook, ``observe_cluster(view)``, called by its
``ClusterAggregator`` after every collect:

* :class:`SLOMonitor` latches ``straggler_suspect`` — the cluster
  view attributed a straggler (step-time/compute skew, a rank falling
  behind, or a stale frame/heartbeat) — re-arming when the
  attribution clears or moves to another rank;
* :class:`DriftMonitor` latches ``rank_divergence`` — the cross-rank
  loss-window spread left its band: a rank is training on different
  state than its peers.
"""
import time
from collections import deque

__all__ = ['SLOMonitor', 'DriftMonitor', 'MemoryMonitor']

_MONO = time.monotonic


def _emit(kind, **data):
    from . import event
    return event(kind, **data)


class SLOMonitor:
    """Watches the aggregator's serving windows at request-finish
    cadence, every ``check_every``-th finish (never per decoded
    token, never on an unchanged window).

    ttft_budget_s   the aggregate TTFT p99 allowance.  Defaults to the
                    watchdog Budget's first-step allowance
                    (``budget.ttft_budget_s()``) when a budget is
                    given — queueing + prefill ride on the same
                    envelope the per-request deadlines derive from.
    deadline_evict_frac  breach when more than this fraction of the
                    window's finished requests were deadline
                    evictions.
    min_samples     windows thinner than this never fire (startup
                    noise is not an SLO breach).
    """

    def __init__(self, budget=None, ttft_budget_s=None,
                 deadline_evict_frac=0.5, min_samples=8,
                 rearm_frac=0.7, check_every=4):
        if ttft_budget_s is None and budget is not None:
            ttft_budget_s = budget.ttft_budget_s()
        self.ttft_budget_s = (None if ttft_budget_s is None
                              else float(ttft_budget_s))
        self.deadline_evict_frac = float(deadline_evict_frac)
        self.min_samples = int(min_samples)
        self.rearm_frac = float(rearm_frac)
        # the window check sorts up to the full reservoir and runs
        # under the aggregator lock on the emission path: bound it to
        # request-finish cadence AND every Nth finish
        self.check_every = max(1, int(check_every))
        self._seen = 0
        self._latched = set()           # which signals already fired
        self.breaches = []              # local record (tests/reports)

    def observe(self, rec, agg):
        if rec.get('kind') == 'plan_swap':
            # a new plan means new budgets: clear the latch so the
            # NEXT breach (under the new plan) is a fresh edge, not a
            # hangover from the plan the supervisor just retired
            self._latched.clear()
            return
        # TTFT and deadline-eviction state only change when a request
        # finishes — serve_step would re-check an unchanged window
        if rec.get('kind') != 'serve_request':
            return
        self._seen += 1
        if self._seen % self.check_every:
            return
        now = _MONO()
        self._check_ttft(agg, now)
        self._check_deadline_rate(agg, now)

    def _fire(self, what, **data):
        self._latched.add(what)
        ev = _emit('slo_breach', what=what, **data)
        self.breaches.append(ev or dict(kind='slo_breach', what=what,
                                        **data))

    def _check_ttft(self, agg, now):
        if self.ttft_budget_s is None:
            return
        pct = agg.ttft.percentiles(now)
        if pct.get('count', 0) < self.min_samples:
            return
        p99 = pct['p99']
        if 'ttft_p99' in self._latched:
            if p99 <= self.ttft_budget_s * self.rearm_frac:
                self._latched.discard('ttft_p99')    # re-arm
            return
        if p99 > self.ttft_budget_s:
            self._fire('ttft_p99', observed_s=round(p99, 4),
                       budget_s=self.ttft_budget_s,
                       window_count=pct['count'])

    # -- cluster hook (telemetry.cluster.ClusterAggregator) ------------------
    def observe_cluster(self, view):
        """Latch ``straggler_suspect`` off one cluster view: the
        aggregator attributed a straggler and this monitor had not yet
        fired for that rank.  Re-arms when the attribution clears (or
        moves — a NEW straggler rank fires again: the supervisor needs
        every edge, not just the first)."""
        strag = (view or {}).get('straggler')
        if not strag:
            self._latched.discard('straggler')
            self._strag_rank = None
            return
        rank = strag.get('rank')
        if 'straggler' in self._latched \
                and getattr(self, '_strag_rank', None) == rank:
            return
        self._strag_rank = rank
        self._latched.add('straggler')
        # the suspect rides as 'suspect', NOT 'rank': the JSONL writer
        # stamps every record with the EMITTING host's rank (the
        # aggregator's rank 0), which would clobber the attribution
        ev = _emit('straggler_suspect', suspect=rank,
                   cause=strag.get('cause'), skew=strag.get('skew'),
                   behind=strag.get('behind'),
                   hb_stale=strag.get('hb_stale'),
                   world=view.get('world'),
                   max_step=view.get('max_step'))
        self.breaches.append(ev or dict(kind='straggler_suspect',
                                        suspect=rank, **strag))

    def _check_deadline_rate(self, agg, now):
        dl = agg.by_cause.get('deadline')
        if dl is None:
            return
        breached = dl.windowed(now)
        finished = agg.finished.windowed(now)
        if finished < self.min_samples:
            return
        frac = breached / finished
        if 'deadline_evictions' in self._latched:
            if frac <= self.deadline_evict_frac * self.rearm_frac:
                self._latched.discard('deadline_evictions')
            return
        if frac > self.deadline_evict_frac:
            self._fire('deadline_evictions',
                       observed_frac=round(frac, 4),
                       threshold_frac=self.deadline_evict_frac,
                       breached=int(breached), finished=int(finished))


class DriftMonitor:
    """Predicted-vs-observed drift over ``collective_observed`` events
    plus the post-steady compile detector.

    ratio_band      fire when the windowed mean us_ratio of one op's
                    call site leaves [1/band, band] (default 4.0 — an
                    uncalibrated model is routinely ~2x off; 4x is a
                    regime change).
    min_windows     observations of one instr needed before its ratio
                    is trusted.
    warmup_events   ``compile`` events within the aggregator's pre-
                    steady phase are warmup, never drift; after
                    ``agg.mark_steady()`` every compile fires (once,
                    latched per compile name).
    """

    def __init__(self, ratio_band=4.0, min_windows=1, window=8):
        self.ratio_band = float(ratio_band)
        if self.ratio_band <= 1.0:
            raise ValueError('ratio_band must be > 1')
        self.min_windows = int(min_windows)
        self._ratios = {}               # (op, instr) -> deque of ratio
        self._window = int(window)
        self._latched = set()
        self._post_swap_compiles = 0
        self.detections = []            # local record (tests/reports)

    def observe(self, rec, agg):
        kind = rec.get('kind')
        if kind == 'plan_swap':
            # the swapped-in plan predicts with different constants
            # and compiles fresh modules: stale ratio windows (and the
            # retired plan's latches) would mis-attribute the new
            # plan's first observations as drift — or suppress real
            # drift under a recycled latch key
            self._ratios.clear()
            self._latched.clear()
            # the swapped plan's own rebuild (per-step and/or fused
            # module) compiles AFTER steady by construction — it is
            # the actuation, not drift
            self._post_swap_compiles = 2
        elif kind == 'collective_observed':
            self._observe_collective(rec)
        elif kind == 'compile':
            if self._post_swap_compiles > 0:
                self._post_swap_compiles -= 1
                return
            self._observe_compile(rec, agg)

    def _fire(self, cause, key, **data):
        self._latched.add(key)
        ev = _emit('drift_detected', cause=cause, **data)
        self.detections.append(ev or dict(kind='drift_detected',
                                          cause=cause, **data))

    def _observe_collective(self, rec):
        us, pred = rec.get('us'), rec.get('predicted_us')
        if not us or not pred:
            return
        key = (rec.get('op'), rec.get('instr'))
        ratios = self._ratios.setdefault(
            key, deque(maxlen=self._window))
        ratios.append(us / pred)
        if len(ratios) < self.min_windows:
            return
        mean = sum(ratios) / len(ratios)
        lkey = ('us_ratio',) + key
        inside = 1.0 / self.ratio_band <= mean <= self.ratio_band
        if lkey in self._latched:
            # hysteresis: re-arm only once comfortably back in band —
            # halfway between 1.0 and the band edge, so the re-arm
            # window is non-empty for ANY band > 1 (band/2 was empty
            # for band <= 2)
            rearm = 1.0 + (self.ratio_band - 1.0) / 2.0
            if 1.0 / rearm <= mean <= rearm:
                self._latched.discard(lkey)
            return
        if not inside:
            self._fire('us_ratio', lkey, op=rec.get('op'),
                       instr=rec.get('instr'),
                       us_ratio=round(mean, 4),
                       band=self.ratio_band,
                       observed_us=round(us, 3),
                       predicted_us=round(pred, 3),
                       windows=len(ratios))

    def _observe_compile(self, rec, agg):
        if agg.steady_since is None:
            return
        name = rec.get('name', '?')
        lkey = ('compile', name)
        if lkey in self._latched:
            return
        self._fire('post_steady_compile', lkey, name=name,
                   dur_s=rec.get('dur_s'))

    # -- cluster hook (telemetry.cluster.ClusterAggregator) ------------------
    def observe_cluster(self, view):
        """Latch ``rank_divergence`` off one cluster view: the
        cross-rank loss-window spread left its band (a rank trains on
        different state — corrupt restore, leaked collective fault,
        desynced rng).  Hysteresis: re-arms at half the band."""
        div = (view or {}).get('loss_divergence')
        lkey = ('rank_divergence',)
        if not div:
            return
        spread = div.get('spread') or 0.0
        band = div.get('band') or 0.0
        if lkey in self._latched:
            if spread <= band * 0.5:
                self._latched.discard(lkey)
            return
        if div.get('divergent'):
            self._latched.add(lkey)
            ev = _emit('rank_divergence', spread=spread, band=band,
                       per_rank=div.get('per_rank'),
                       world=view.get('world'),
                       max_step=view.get('max_step'))
            self.detections.append(ev or dict(kind='rank_divergence',
                                              spread=spread))


class MemoryMonitor:
    """Live HBM high-water vs budget, latched exactly-once.

    Observes the boundary-rate ``memory_sample`` records the
    :class:`telemetry.memory.MemorySampler` emits (device bytes from
    ``torch.cuda.memory_stats()`` on the card, the host census on the
    CPU) and
    fires ONE ``memory_pressure`` event when the live bytes cross
    ``budget_bytes * watermark`` — the edge the plan supervisor
    re-plans on with a tightened ``hbm_budget_gb``.  Re-arms with
    hysteresis (bytes back under ``watermark * rearm_frac`` of the
    budget) and on ``plan_swap`` (a new plan means a new memory
    footprint: the next breach is a fresh edge).

    budget_bytes    the live-bytes allowance.  Defaults to the
                    sampler's own MemConfig budget (budget_gb in the
                    PADDLE_TPU_MEMSTATS grammar) when a config is
                    given; without any budget the monitor is dormant.
    watermark       breach threshold as a fraction of budget (0.9).
    rearm_frac      hysteresis fraction of the firing threshold.
    """

    def __init__(self, budget_bytes=None, config=None, watermark=None,
                 rearm_frac=None):
        if config is not None:
            if budget_bytes is None:
                budget_bytes = config.budget_bytes
            if watermark is None:
                watermark = config.watermark
            if rearm_frac is None:
                rearm_frac = config.rearm_frac
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self.watermark = 0.9 if watermark is None else float(watermark)
        self.rearm_frac = 0.7 if rearm_frac is None else float(rearm_frac)
        self._latched = set()
        self.breaches = []              # local record (tests/reports)

    def observe(self, rec, agg):
        kind = rec.get('kind')
        if kind == 'plan_swap':
            # the swapped-in plan reshapes the footprint (that was the
            # point of the re-plan): the next breach is a fresh edge
            self._latched.clear()
            return
        if kind != 'memory_sample' or self.budget_bytes is None:
            return
        observed = rec.get('device_bytes')
        if observed is None:
            return
        threshold = self.budget_bytes * self.watermark
        if 'memory' in self._latched:
            if observed <= threshold * self.rearm_frac:
                self._latched.discard('memory')      # re-arm
            return
        if observed > threshold:
            self._latched.add('memory')
            ev = _emit('memory_pressure',
                       observed_bytes=int(observed),
                       peak_bytes=rec.get('device_peak_bytes'),
                       budget_bytes=self.budget_bytes,
                       watermark=self.watermark,
                       frac=round(observed / self.budget_bytes, 4),
                       source=rec.get('source'))
            self.breaches.append(ev or dict(
                kind='memory_pressure', observed_bytes=int(observed),
                budget_bytes=self.budget_bytes))
