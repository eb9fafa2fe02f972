"""Deterministic, seeded fault injection: the serving half (the port's
copy of ``paddle_tpu/resilience/chaos.py`` up to its ``ChaosEngine``).

A :class:`FaultPlan` is a declarative, *seeded* list of faults, JSON
serialisable (``PADDLE_TPU_CHAOS_PLAN`` ships one to a worker):

    plan = FaultPlan(seed=0, faults=[
        Fault('replica_kill', after_tokens=3, count=1),
    ])

The kinds, their legality (an unknown kind raises) and the JSON form
are the reference's, so a plan written for one package runs under the
other.  :class:`ServingFaultInjector` interprets the four serving kinds
(``replica_kill``, ``replica_hang``, ``client_disconnect``,
``slow_client``) at a fleet drill's two seams; every firing is recorded
in ``injected`` and, given a telemetry module, as a ``fault_injected``
event.

The training seams (``ChaosEngine``, ``ChaosCallback``,
``ChaosCluster``, ``check_invariants`` over checkpoints) wait for the
port's checkpointing and multi-process training; a plan may name their
kinds, but nothing in the port applies them yet.
"""
import json
import os

__all__ = ['FAULT_KINDS', 'COLLECTIVE_FAULT_KINDS',
           'SERVING_FAULT_KINDS', 'Fault', 'FaultPlan',
           'ServingFaultInjector', 'plan_from_env', 'PLAN_ENV']

PLAN_ENV = 'PADDLE_TPU_CHAOS_PLAN'

# faults that land on the host-collective wire (distributed.collective
# HostCollectives) — the seam class added for the multi-process chaos
# topology, and the one that must exist BEFORE quantized (EQuARX)
# collectives change what travels on it
COLLECTIVE_FAULT_KINDS = (
    'collective_delay',    # sleep delay_s before posting the payload
    'collective_hang',     # go silent: never post; peers time out and
                           # the abort flag (or delay_s) releases us
    'collective_drop',     # participant drops out: raise mid-collective
    'collective_corrupt',  # flip a payload byte AFTER the crc header
                           # is computed — receivers must detect it
)

# faults that land on the serving fleet (serving/router.py front
# door): injected by the fleet drill through ServingFaultInjector's
# two seams, NOT by ChaosEngine's file/step/collective hooks — a
# serving drill has no training step to key on, so these fire on
# stream progress (`after_tokens`) instead of `at_step`.  Opt-in via
# plangen.OPTIN_KINDS, same draw-stream-stability reasoning as
# collective_skip.
SERVING_FAULT_KINDS = (
    'replica_kill',       # SIGKILL a fleet replica once a targeted
                          # stream has emitted after_tokens tokens —
                          # the router must land every in-flight rid
                          # in a terminal state: retried bit-exact on
                          # a survivor, or failed TYPED (never lost)
    'replica_hang',       # SIGSTOP a replica: its streams stall past
                          # the router's read timeout; looks like a
                          # dead peer that still holds the port, so
                          # detection cannot rely on process exit
    'client_disconnect',  # drop the CLIENT connection mid-stream
                          # after after_tokens tokens — the frontend
                          # must evict the rid and roll its tokens
                          # back (PR-12 preemption accounting)
    'slow_client',        # client stops reading between events for
                          # delay_s — backpressure must not wedge the
                          # engine thread or starve other streams
)

FAULT_KINDS = (
    'io_error',          # raise OSError(errno) from matching file writes
    'slow_io',           # sleep delay_s inside matching file writes
    'torn_write',        # leave a truncated tmp file, skip the rename
    'drop_commit',       # save barrier passes, manifest never written
    'corrupt_shard',     # flip bytes in the largest committed payload
    'truncate_shard',    # truncate the largest committed payload
    'sigterm',           # graceful preemption at step N
    'sigkill',           # hard crash at step N
    'delete_heartbeat',  # remove the heartbeat file at step N
    'stale_heartbeat',   # back-date the heartbeat mtime at step N
    'nan_grads',         # poison the step-N batch with NaN
    'slow_rank',         # throttle this rank's step N by delay_s (the
                         # straggler the watchdog must attribute)
    'drift',             # emit a synthetic drift_detected at step N
                         # (op + us_ratio): the sustained sensor edge
                         # the plan supervisor must actuate on exactly
                         # once — chaos-grade drift without waiting
                         # for a real profiled collective to degrade
    'collective_skip',   # rank silently SKIPS a matching collective
                         # (no post, no ledger entry) and proceeds —
                         # the SPMD-contract violation the collective
                         # flight recorder must attribute to its call
                         # site.  Deliberately NOT in
                         # COLLECTIVE_FAULT_KINDS: growing that tuple
                         # would shift plangen's seeded draw stream
                         # and break golden-pinned plans (opt-in via
                         # plangen.OPTIN_KINDS, the 'drift' precedent)
) + COLLECTIVE_FAULT_KINDS + SERVING_FAULT_KINDS


class Fault:
    """One declarative fault.

    kind        one of FAULT_KINDS.
    at_step     fire exactly at this training step (process/grads/
                collective seams), or at the save of this step (ckpt
                seam).
    prob        fire probabilistically per opportunity (file seam);
                drawn from the plan's seeded RNG.
    count       max number of injections (default 1 for at_step
                faults, unbounded for prob faults).
    path        substring filter on the file path (file/ckpt seams).
    errno_name  'EIO' | 'ENOSPC' | ... for io_error.
    delay_s     sleep for slow_io / collective_delay / slow_rank, and
                the hang duration cap for collective_hang.
    rank        only fire on this cluster rank (None = any rank) —
                multi-process plans slice per rank; see
                FaultPlan.slice_for_rank.
    op          substring filter on the collective op/tag (collective
                seams; e.g. 'allreduce' or 'step7'), and the drifted
                collective kind for ``drift`` faults (default
                'all-reduce').
    us_ratio    observed/predicted ratio a ``drift`` fault reports
                (default 8.0 — far outside the monitor's 4x band).
    after_tokens  serving seams (SERVING_FAULT_KINDS): fire once the
                targeted stream has emitted this many tokens — the
                serving analogue of at_step (a drill has no training
                step; stream progress is its clock).  `rank` selects
                the replica index for replica_* kinds; `path`
                substring-filters the rid.
    """

    def __init__(self, kind, at_step=None, prob=None, count=None,
                 path=None, errno_name='EIO', delay_s=0.05,
                 rank=None, op=None, us_ratio=None,
                 after_tokens=None):
        if kind not in FAULT_KINDS:
            raise ValueError(f'unknown fault kind {kind!r}; '
                             f'one of {FAULT_KINDS}')
        self.kind = kind
        self.at_step = at_step
        self.prob = prob
        self.count = count if count is not None else \
            (1 if at_step is not None else None)
        self.path = path
        self.errno_name = errno_name
        self.delay_s = delay_s
        self.rank = rank
        self.op = op
        self.us_ratio = us_ratio
        self.after_tokens = None if after_tokens is None \
            else int(after_tokens)
        self.fired = 0

    _FIELDS = ('kind', 'at_step', 'prob', 'count', 'path',
               'errno_name', 'delay_s', 'rank', 'op', 'us_ratio',
               'after_tokens')

    def to_dict(self):
        d = {k: getattr(self, k) for k in self._FIELDS}
        # us_ratio / after_tokens joined the schema after plans were
        # golden-pinned: omit them when unset so every pre-existing
        # plan's canonical JSON (and fingerprint) stays byte-identical
        for late in ('us_ratio', 'after_tokens'):
            if d[late] is None:
                del d[late]
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in d.items() if k in cls._FIELDS})

    def _exhausted(self):
        return self.count is not None and self.fired >= self.count

    def __repr__(self):
        bits = [self.kind]
        if self.at_step is not None:
            bits.append(f'at_step={self.at_step}')
        if self.prob is not None:
            bits.append(f'prob={self.prob}')
        if self.rank is not None:
            bits.append(f'rank={self.rank}')
        if self.op is not None:
            bits.append(f'op={self.op!r}')
        return f'Fault({", ".join(bits)})'


class FaultPlan:
    """A seeded, declarative set of faults — JSON-serializable so the
    chaos_run tool can ship it to a worker subprocess through one
    env var and a replayed run sees the identical plan."""

    def __init__(self, seed=0, faults=(), name=None):
        self.seed = int(seed)
        self.faults = [f if isinstance(f, Fault) else Fault.from_dict(f)
                       for f in faults]
        self.name = name

    def to_json(self):
        return json.dumps({'seed': self.seed, 'name': self.name,
                           'faults': [f.to_dict() for f in self.faults]},
                          sort_keys=True)

    @classmethod
    def from_json(cls, text):
        d = json.loads(text)
        return cls(seed=d.get('seed', 0), faults=d.get('faults', ()),
                   name=d.get('name'))

    def slice_for_rank(self, rank):
        """This rank's share of a cluster plan: faults addressed to
        `rank` plus the unaddressed ones.  The SEED is unchanged —
        same cluster seed => every rank replays its identical injected
        sequence, and the union over ranks is the plan's sequence."""
        rank = int(rank)
        faults = [Fault.from_dict(f.to_dict()) for f in self.faults
                  if f.rank is None or int(f.rank) == rank]
        return FaultPlan(seed=self.seed, faults=faults,
                         name=f'{self.name or "plan"}@r{rank}')

    def mark_fired(self, events, rank=None):
        """Replay the fault ledger into this plan: count the
        ``fault_injected`` records a PREVIOUS incarnation already
        injected (telemetry JSONL + flight dumps survive the process)
        and advance each bounded fault's ``fired`` counter, so a
        restarted worker re-reading the same plan does not re-kill /
        re-hang itself at the same step forever — while faults it has
        NOT yet reached still fire.  Returns the number of ledger
        entries applied."""
        applied = 0
        for f in self.faults:
            if f.count is None:
                continue        # unbounded prob faults may refire
            n = 0
            for e in events:
                if e.get('kind') != 'fault_injected':
                    continue
                if e.get('fault') != f.kind:
                    continue
                if rank is not None and e.get('rank', 0) != rank:
                    continue
                if f.at_step is not None \
                        and e.get('step') != f.at_step:
                    continue
                if f.op is not None and f.op not in str(
                        e.get('op') or e.get('tag') or ''):
                    continue
                n += 1
            if n:
                f.fired = min(f.count, f.fired + n)
                applied += n
        return applied


def plan_from_env(env=PLAN_ENV):
    """The FaultPlan shipped via the environment, or None.  Workers
    call this at startup."""
    text = os.environ.get(env)
    return FaultPlan.from_json(text) if text else None


class ServingFaultInjector:
    """Interprets a plan's SERVING_FAULT_KINDS at the fleet drill's
    two seams — the serving counterpart of ChaosEngine (which patches
    file/step/collective seams a serving drill never crosses).

    The drill (``chip_smoke.py``'s fleet phase, the fleet
    tests) calls:

    * :meth:`fleet_faults` from its on_token tap: replica-side kinds
      (replica_kill / replica_hang) due at this stream offset — the
      drill applies them with ``ReplicaHandle.kill(SIGKILL|SIGSTOP)``;
    * :meth:`client_faults` from the client read loop:
      client_disconnect (close the socket now) and slow_client (sleep
      ``delay_s`` before the next read).

    Faults stay declarative and seeded exactly like every other kind:
    same plan JSON => same injected sequence, and each firing is
    recorded so an audit can line the ledger up against what was
    actually injected.
    """

    def __init__(self, plan, telemetry=None):
        self.plan = plan
        self.faults = [f for f in plan.faults
                       if f.kind in SERVING_FAULT_KINDS]
        self.telemetry = telemetry
        self.injected = []      # [{'fault', 'rid', 'emitted'}, ...]

    def _due(self, kinds, rid, emitted, replica_index=None):
        out = []
        for f in self.faults:
            if f.kind not in kinds or f._exhausted():
                continue
            if f.path is not None and f.path not in str(rid):
                continue
            if f.after_tokens is not None and emitted < f.after_tokens:
                continue
            if f.rank is not None and replica_index is not None \
                    and int(f.rank) != int(replica_index):
                continue
            f.fired += 1
            rec = {'fault': f.kind, 'rid': rid, 'emitted': emitted}
            self.injected.append(rec)
            if self.telemetry is not None:
                self.telemetry.event('fault_injected', fault=f.kind,
                                     rid=str(rid), emitted=emitted)
            out.append(f)
        return out

    def fleet_faults(self, rid, emitted, replica_index=None):
        """replica_kill / replica_hang due now for stream `rid` at
        global offset `emitted` (replica_index = position of the
        serving replica in the fleet's active list, matched against
        the fault's `rank`)."""
        return self._due(('replica_kill', 'replica_hang'), rid,
                         emitted, replica_index)

    def client_faults(self, rid, emitted):
        """client_disconnect / slow_client due now on `rid`'s client
        connection."""
        return self._due(('client_disconnect', 'slow_client'), rid,
                         emitted)
