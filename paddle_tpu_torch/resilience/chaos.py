"""Deterministic, seeded fault injection (the port's copy of
``paddle_tpu/resilience/chaos.py``).

A :class:`FaultPlan` is a declarative, *seeded* list of faults, JSON
serialisable (``PADDLE_TPU_CHAOS_PLAN`` ships one to a worker):

    plan = FaultPlan(seed=7, faults=[
        Fault('io_error', path='_PADDLE_COMMIT', prob=0.5,
              errno_name='EIO'),
        Fault('torn_write', path='step_3'),
        Fault('sigkill', at_step=5),
        Fault('nan_grads', at_step=4),
    ])

The kinds, their legality (an unknown kind raises) and the JSON form
are the reference's, so a plan written for one package runs under the
other.  A :class:`ChaosEngine` applies the training kinds through
scoped monkeypatch seams on the boundaries real failures hit:

  file seam        ``resilience.manifest.atomic_write`` — EIO/ENOSPC,
                   slow writes, torn writes (half the bytes under the
                   real name, no rename).  The port's checkpoint writer
                   puts every payload through it, so a torn payload is
                   caught by the manifest's recorded sizes and digests.
  ckpt seam        ``distributed.checkpoint._SaveHandle.wait`` — a
                   dropped commit (the writer drains, the manifest never
                   lands), or a committed payload corrupted or truncated
                   the instant its commit lands; the handle carries its
                   directory, so a fault's ``path`` filters it as on
                   the file seam (the reference's handle has none, so
                   there a pathless fault damages nothing).
  process seam     ``engine.step(n)`` called from the training loop —
                   SIGTERM, SIGKILL, heartbeat files deleted or
                   back-dated, a throttled (``slow_rank``) step.
  grads seam       ``engine.poison(n, *arrays)`` — NaN written into the
                   step-N batch (numpy arrays or tensors).

Every probabilistic decision comes from ``random.Random(plan.seed)``,
consulted in a fixed seam order, so the same plan replays the same
injected sequence (``engine.sequence()``); every injection lands in
telemetry as ``fault_injected``.  :func:`check_invariants` (I1-I7) is
the assertion side and :func:`load_run_events` merges a supervised
run's telemetry.  :class:`ServingFaultInjector` interprets the four
serving kinds at a fleet drill's two seams.

Not ported yet: the collective seams (the four ``collective_*`` kinds
and ``collective_skip``) and ``drift`` need ``distributed.collective``
and the plan supervisor, and :class:`ChaosCluster` the multi-process
topology (ROADMAP Queue 1 items 9 and 10): a ChaosEngine given such a
fault, and ChaosCluster, raise ``NotImplementedError``.
"""
import errno as _errno
import json
import os
import random
import signal
import time

__all__ = ['FAULT_KINDS', 'COLLECTIVE_FAULT_KINDS',
           'SERVING_FAULT_KINDS', 'Fault', 'FaultPlan', 'ChaosEngine',
           'ChaosCallback', 'ChaosCluster', 'ServingFaultInjector',
           'check_invariants', 'plan_from_env', 'load_run_events',
           'PLAN_ENV']

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


# kinds whose seams wait for later slices (ChaosEngine refuses them)
_WAITING_KINDS = COLLECTIVE_FAULT_KINDS + ('collective_skip', 'drift')


class ChaosEngine:
    """Applies one FaultPlan through scoped monkeypatch seams.

    Use as a context manager (``with ChaosEngine(plan) as eng:``) or
    via activate()/deactivate().  All patches are process-local and
    fully undone on exit.
    """

    def __init__(self, plan, heartbeat_file=None, rank=None):
        self.plan = plan if isinstance(plan, FaultPlan) else \
            FaultPlan(**plan) if isinstance(plan, dict) else plan
        self.rng = random.Random(self.plan.seed)
        self.heartbeat_file = heartbeat_file
        self.rank = (int(rank) if rank is not None else
                     int(os.environ.get('PADDLE_TRAINER_ID', 0) or 0))
        self.injected = []          # deterministic injection log
        self._saved = []            # (obj, attr, original) undo stack
        self._active = False
        self._current_step = None   # the last step() seen

    # -- bookkeeping ---------------------------------------------------------

    def record(self, fault, **info):
        """One injection: appended to the deterministic sequence and
        emitted as a ``fault_injected`` telemetry event.  Every entry
        carries a rank (seam-provided, else the engine's own) so
        in-memory consumers and flight-ring copies stay attributable
        without relying on the JSONL writer's per-process tag."""
        fault.fired += 1
        entry = dict(fault=fault.kind, seq=len(self.injected), **info)
        entry.setdefault('rank', self.rank)
        self.injected.append(entry)
        try:
            from .. import telemetry
            telemetry.event('fault_injected', seed=self.plan.seed,
                            plan=self.plan.name, **entry)
            telemetry.add('chaos.injected')
        except Exception:       # pragma: no cover - defensive
            pass
        return entry

    def sequence(self):
        """The injected-fault sequence so far — the replayability
        contract: same plan (same seed), same scenario ⇒ identical
        sequence."""
        return list(self.injected)

    def _matching(self, kinds, path=None, step=None, op=None,
                  rank=None):
        """Armed faults of `kinds` matching the path/step/op/rank
        filters, in plan order (deterministic).  `rank` defaults to
        the engine's own rank; the collective seam passes the POSTING
        transport's rank instead (class-level patches see every
        transport in the process — in-process multi-rank tests would
        otherwise misattribute rank-addressed wire faults)."""
        rank = self.rank if rank is None else int(rank)
        out = []
        for f in self.plan.faults:
            if f.kind not in kinds or f._exhausted():
                continue
            if f.rank is not None and int(f.rank) != rank:
                continue
            if path is not None and f.path is not None \
                    and f.path not in str(path):
                continue
            if step is not None and f.at_step is not None \
                    and f.at_step != step:
                continue
            if path is None and f.path is not None:
                continue
            # a drift fault's `op` is PAYLOAD (which collective the
            # synthetic sensor edge reports), not an op-seam address —
            # the step loop that fires it has no op context
            if f.op is not None and f.kind != 'drift' \
                    and (op is None or f.op not in str(op)):
                continue
            out.append(f)
        return out

    def _roll(self, fault):
        """Seeded probability gate.  at_step faults fire
        deterministically; prob faults consult the plan RNG — one draw
        per opportunity, so the decision stream is a pure function of
        the seed and the seam-call order."""
        if fault.prob is None:
            return True
        return self.rng.random() < fault.prob

    # -- seams ---------------------------------------------------------------

    def _patch(self, obj, attr, repl):
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, repl)

    def activate(self):
        if self._active:
            return self
        waiting = sorted({f.kind for f in self.plan.faults
                          if f.kind in _WAITING_KINDS})
        if waiting:
            raise NotImplementedError(
                f'ChaosEngine: {waiting} need the host transport of '
                'distributed.collective and the plan supervisor, which are '
                'not ported yet (ROADMAP Queue 1 item 9b, second part, '
                'and item 10)')
        from . import manifest as _manifest
        from ..distributed import checkpoint as _ckpt

        orig_write = _manifest.atomic_write

        def chaotic_atomic_write(path, write_fn, mode='w',
                                 prefix='.tmp'):
            for f in self._matching(('io_error',), path=path):
                if self._roll(f):
                    self.record(f, path=str(path),
                                errno=f.errno_name)
                    code = getattr(_errno, f.errno_name, _errno.EIO)
                    raise OSError(code, os.strerror(code), str(path))
            for f in self._matching(('slow_io',), path=path):
                if self._roll(f):
                    self.record(f, path=str(path), delay_s=f.delay_s)
                    time.sleep(f.delay_s)
            for f in self._matching(('torn_write',), path=path):
                if self._roll(f):
                    # what a dying writer leaves on a non-atomic fs:
                    # half the bytes under the REAL name, no fsync, no
                    # rename discipline — the strongest tear the
                    # verify/quarantine path must catch
                    import io
                    buf = io.BytesIO() if 'b' in mode else io.StringIO()
                    write_fn(buf)
                    data = buf.getvalue()
                    half = data[:max(1, len(data) // 2)]
                    with open(path, 'wb' if 'b' in mode else 'w') as fh:
                        fh.write(half)
                    self.record(f, path=str(path),
                                bytes_kept=len(half))
                    return
            return orig_write(path, write_fn, mode=mode, prefix=prefix)

        self._patch(_manifest, 'atomic_write', chaotic_atomic_write)

        orig_wait = _ckpt._SaveHandle.wait
        eng = self

        def chaotic_wait(handle):
            step = getattr(handle, '_step', None)
            path = handle.path
            for f in eng._matching(('drop_commit',), path=path, step=step):
                if eng._roll(f):
                    # the writer drains but the process "dies" before
                    # its commit: exactly the SIGKILL-between-save-and-
                    # commit window, minus the actual kill
                    if not handle._drained:
                        handle._drain()
                        handle._drained = True
                    handle._done = True
                    eng.record(f, step=step)
                    return
            orig_wait(handle)
            for f in eng._matching(('corrupt_shard', 'truncate_shard'),
                                   path=path, step=step):
                if eng._roll(f) and path and os.path.isdir(path):
                    victim = eng._damage_dir(
                        path, flip=f.kind == 'corrupt_shard')
                    eng.record(f, step=step, path=victim)

        self._patch(_ckpt._SaveHandle, 'wait', chaotic_wait)
        self._active = True
        return self

    def deactivate(self):
        while self._saved:
            obj, attr, orig = self._saved.pop()
            setattr(obj, attr, orig)
        self._active = False

    def __enter__(self):
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()
        return False

    @staticmethod
    def _damage_dir(directory, flip=True):
        """Largest payload file in `directory`: byte-flip (bit-level
        corruption under an intact size) or truncate (torn write)."""
        from .manifest import MANIFEST_NAME, TWO_PHASE_DIR
        victim, size = None, -1
        for root, dirs, files in os.walk(directory):
            if TWO_PHASE_DIR in dirs:
                dirs.remove(TWO_PHASE_DIR)
            for f in files:
                if f == MANIFEST_NAME:
                    continue
                p = os.path.join(root, f)
                if os.path.getsize(p) > size:
                    victim, size = p, os.path.getsize(p)
        if victim is None:
            return None
        with open(victim, 'r+b') as fh:
            if flip:
                fh.seek(max(0, size // 2))
                b = fh.read(1)
                fh.seek(max(0, size // 2))
                fh.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
            else:
                fh.truncate(max(0, size // 2))
        return victim

    # -- process / heartbeat seam -------------------------------------------

    def step(self, step_no):
        """Call once per training step (the chaos_run worker and the
        ChaosCallback do).  Fires process-level faults scheduled for
        this step: SIGTERM (latched by GracefulShutdown → graceful
        preemption), SIGKILL (hard crash), heartbeat tampering,
        slow-rank throttling."""
        self._current_step = step_no
        for f in self._matching(('slow_rank',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                # the deliberate straggler: this rank's step runs, just
                # late — the watchdog's soft threshold must attribute
                # it without killing anything
                self.record(f, step=step_no, rank=self.rank,
                            delay_s=f.delay_s)
                time.sleep(f.delay_s)
        for f in self._matching(('delete_heartbeat',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                hb = self.heartbeat_file
                self.record(f, step=step_no, path=hb)
                if hb:
                    try:
                        os.remove(hb)
                    except OSError:
                        pass
        for f in self._matching(('stale_heartbeat',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                hb = self.heartbeat_file
                self.record(f, step=step_no, path=hb)
                if hb and os.path.exists(hb):
                    past = time.time() - 10_000
                    os.utime(hb, (past, past))
        for f in self._matching(('sigterm',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                self.record(f, step=step_no, signum=int(signal.SIGTERM))
                os.kill(os.getpid(), signal.SIGTERM)
        for f in self._matching(('sigkill',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                self.record(f, step=step_no, signum=int(signal.SIGKILL))
                # record must be durable first: SIGKILL gives no
                # chance to flush anything afterwards
                try:
                    from .. import telemetry
                    d = telemetry.flight_dir()
                    if d:
                        telemetry.dump_flight(os.path.join(
                            d, f'flightrec-chaos-kill-{step_no}.json'))
                except Exception:
                    pass
                os.kill(os.getpid(), signal.SIGKILL)

    def poison(self, step_no, *arrays):
        """NaN-inject the step-N batch (grads seam): returns the arrays,
        with element [0, ...] of each float one set to NaN (in a copy)
        when a ``nan_grads`` fault fires for this step.  Takes numpy
        arrays and tensors; ids pass through untouched."""
        import numpy as np
        import torch
        fired = False
        for f in self._matching(('nan_grads',), step=step_no):
            if f.at_step == step_no and self._roll(f):
                self.record(f, step=step_no)
                fired = True
        if not fired:
            return arrays if len(arrays) != 1 else arrays[0]
        out = []
        for a in arrays:
            if torch.is_tensor(a):
                a = a.clone()
                if a.is_floating_point():
                    a.view(-1)[0] = float('nan')
            else:
                a = np.array(a, copy=True)
                if np.issubdtype(a.dtype, np.floating):
                    a.reshape(-1)[0] = np.nan
            out.append(a)
        return tuple(out) if len(out) != 1 else out[0]


class ChaosCallback:
    """hapi-style callback adapter: drives ``engine.step`` from
    ``Model.fit``'s batch boundary so a FaultPlan's process-level
    faults apply to hapi training loops too (duck-typed — hapi only
    calls the hooks a callback defines)."""

    def __init__(self, engine):
        self.engine = engine
        self._step = 0

    def set_model(self, model):
        self.model = model

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self.engine.step(self._step)


# -- invariant checking --------------------------------------------------------

def check_invariants(ckpt_dir, prefix='step', events=None,
                     max_restarts=None, restarts=None,
                     preempt_codes=(), expect_committed=True,
                     final_rc=None, duration_s=None, deadline_s=None):
    """Verify the resilience invariant set after a chaos run.

    Returns a list of violation strings (empty == all invariants held):

      I1  every COMMITTED step dir verifies (presence+size+digest) —
          restore() can therefore only ever yield a committed step;
      I2  committed steps seen over time are monotonic
          (``checkpoint_commit`` telemetry events, when provided);
      I3  every restore landed on a step that was committed at the
          time (``checkpoint_restore`` step ∈ committed set);
      I4  preemptions exited PREEMPTED_EXIT_CODE (`preempt_codes`:
          exit codes the supervisor attributed to preemption);
      I5  restarts stayed within budget (when both given);
      I6  no step is published (committed) twice after a restart
          unless an intervening restore rolled back BELOW it — a
          restarted worker that re-commits work it never un-did is
          double-publishing state;
      I7  the cluster either completed (rc 0) or exited preempted,
          within the deadline budget — a deadlocked or wedged cluster
          (any other rc, or `duration_s` > `deadline_s`) is itself an
          invariant violation, whatever its checkpoints look like.
    """
    from . import manifest as M
    from .shutdown import PREEMPTED_EXIT_CODE
    violations = []
    committed = []
    if os.path.isdir(ckpt_dir):
        for f in sorted(os.listdir(ckpt_dir)):
            tag = f[len(prefix) + 1:]
            if not (f.startswith(prefix + '_') and tag.isdigit()):
                continue
            p = os.path.join(ckpt_dir, f)
            if not M.is_committed(p):
                continue
            committed.append(int(tag))
            ok, errs = M.verify_manifest(p)
            if not ok:
                violations.append(
                    f'I1: committed step {tag} fails verification: '
                    f'{errs[:3]}')
    elif expect_committed:
        violations.append(f'I1: checkpoint dir {ckpt_dir} missing')
    if expect_committed and not committed:
        violations.append('I1: no committed step survived the run')
    if events:
        commits = [e.get('step') for e in events
                   if e.get('kind') == 'checkpoint_commit'
                   and e.get('step') is not None]
        # per-incarnation streams may interleave after a rollback
        # restore — monotonic within each rank's stream order is the
        # invariant (a later commit may legitimately re-commit an
        # EARLIER step only after a restore to it).  Restores are
        # emitted as spans (kind='span', name='checkpoint_restore').
        restores = [e.get('step') for e in events
                    if (e.get('kind') == 'checkpoint_restore'
                        or (e.get('kind') == 'span'
                            and e.get('name') == 'checkpoint_restore'))
                    and e.get('step') is not None]
        lo = None
        restored = set(restores)
        for s in commits:
            if lo is not None and s < lo and s not in restored \
                    and (s + 1) not in restored:
                violations.append(
                    f'I2: commit steps not monotonic: {s} after {lo} '
                    'with no intervening restore')
            lo = s if lo is None else max(lo, s)
        commit_set = set(commits) | set(committed)
        for s in restores:
            if s not in commit_set:
                violations.append(
                    f'I3: restore yielded step {s}, which was never '
                    'committed')
        # I6: a step may be committed AGAIN only after a restore that
        # rolled back below it (the replay then legitimately re-earns
        # it).  Walk the merged stream in order, tracking whether a
        # sufficiently-deep restore separates the two commits.
        commit_or_restore = [
            e for e in events
            if (e.get('kind') == 'checkpoint_commit'
                and e.get('step') is not None)
            or ((e.get('kind') == 'checkpoint_restore'
                 or (e.get('kind') == 'span'
                     and e.get('name') == 'checkpoint_restore'))
                and e.get('step') is not None)]
        seen_commit = {}        # step -> index of its last commit
        for i, e in enumerate(commit_or_restore):
            s = e.get('step')
            if e.get('kind') == 'checkpoint_commit':
                if s in seen_commit:
                    prev = seen_commit[s]
                    rolled_back = any(
                        r.get('kind') != 'checkpoint_commit'
                        and r.get('step') < s
                        for r in commit_or_restore[prev + 1:i])
                    if not rolled_back:
                        violations.append(
                            f'I6: step {s} published twice with no '
                            'intervening restore below it')
                seen_commit[s] = i
    for code in preempt_codes:
        if code != PREEMPTED_EXIT_CODE:
            violations.append(
                f'I4: preemption exited {code}, expected '
                f'{PREEMPTED_EXIT_CODE}')
    if max_restarts is not None and restarts is not None \
            and restarts > max_restarts:
        violations.append(
            f'I5: {restarts} failure restarts exceed the '
            f'max_restarts={max_restarts} budget')
    if final_rc is not None and final_rc not in (
            0, PREEMPTED_EXIT_CODE):
        violations.append(
            f'I7: cluster neither completed nor exited preempted '
            f'(rc={final_rc})')
    if deadline_s is not None and duration_s is not None \
            and duration_s > deadline_s:
        violations.append(
            f'I7: run took {duration_s:.1f}s, past the '
            f'{deadline_s:.1f}s deadline budget')
    return violations


class ChaosCluster:
    """The reference's multi-process chaos topology (N workers under
    elastic supervision over a shared key-value transport, collective
    seams, cross-rank final-state agreement).  Not ported yet: it needs
    the host transport of ``distributed.collective`` (ROADMAP Queue 1
    item 9b, second part) and item 10."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'ChaosCluster needs the host transport of '
            'distributed.collective, which is not ported yet (ROADMAP '
            'Queue 1 item 9b, second part, and item 10); supervise one '
            'worker with tools.chaos_run')


def load_run_events(workdir):
    """Every telemetry event of a supervised run under `workdir`:
    streamed JSONL plus the event rings of any flight-recorder dumps
    (a SIGKILLed or watchdog-killed incarnation's last moments only
    survive in its pre-kill dump).  Deduped and wall-clock ordered —
    the input to check_invariants(events=...)."""
    import glob
    events = []
    for f in sorted(glob.glob(os.path.join(
            workdir, '**', 'telemetry-*.jsonl'), recursive=True)):
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue        # torn final line of a dead worker
                if isinstance(rec, dict) and 'kind' in rec:
                    events.append(rec)
    for f in sorted(glob.glob(os.path.join(
            workdir, '**', 'flightrec-*.json'), recursive=True)):
        try:
            with open(f) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        rank = doc.get('rank', 0)
        for rec in doc.get('events', []):
            if isinstance(rec, dict) and 'kind' in rec:
                rec = dict(rec)
                rec.setdefault('rank', rank)
                events.append(rec)
    # an event both streamed and ring-dumped collapses to one, and the
    # merged stream is replayed in wall-clock order
    seen, out = set(), []
    for e in events:
        k = (e.get('ts'), e.get('t'), e.get('kind'), e.get('rank', 0))
        if k in seen:
            continue
        seen.add(k)
        out.append(e)
    out.sort(key=lambda e: e.get('ts') or 0)
    return out
