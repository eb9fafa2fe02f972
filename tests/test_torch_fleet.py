"""The port's replica fleet: router, workers and serving chaos, on the CPU.

- a real fleet: ``launch_fleet`` spawns port workers
  (``python -m paddle_tpu_torch.tools.serve_fleet worker --device
  cpu``, ``gpt_tiny`` under the reference drill's pool and sampling,
  each with its metrics plane: ``/kernels/status.json``,
  ``/memory.json``) behind ``FleetFrontend``; the drills of the reference's front-door
  smoke run against it: a clean twin (no shed, every stream equal to
  one in-process port engine's for the same rid), an overload (typed
  rejections only, every rid terminal), a seeded ``replica_kill``
  through ``ServingFaultInjector`` (the rid retried bit-exact on a
  survivor, the warm spare promoted) and a forced ``slo_breach`` drain
  (zero dropped tokens, the fleet still serving);
- scripted replicas in the style of the reference's tests, and a real
  port replica, each driven by the port's ``FleetRouter`` and by the
  reference's over the same replicas, which must agree on every pick,
  ledger entry, ``router.events`` record, ``fleet_event`` and
  ``check_invariants()`` result: dispatch prefers low load, a death
  mid-stream is retried bit-exact with at-most-once delivery,
  rejections exhaust typed and never silently, a forced alert drains
  the replica and promotes the spare, a duplicate rid is refused at
  both fleet doors, and ``check_invariants()`` stays clean;
- ``ServingFaultInjector`` under the same ``FaultPlan`` gives the same
  ``injected`` list and ``fault_injected`` events as the reference's,
  plans serialise to the same JSON, and an illegal fault raises the
  same error.

Tolerances: token streams exactly equal.
"""
import json
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from paddle_tpu import telemetry as ref_tel
from paddle_tpu.resilience import chaos as ref_chaos
from paddle_tpu.serving import router as ref_router
from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.chaos import (FAULT_KINDS,
                                               SERVING_FAULT_KINDS, Fault,
                                               FaultPlan,
                                               ServingFaultInjector,
                                               plan_from_env)
from paddle_tpu_torch.serving import RejectReason, Request
from paddle_tpu_torch.serving import router as port_router
from paddle_tpu_torch.serving.frontend import ServingFrontend
from paddle_tpu_torch.serving.router import FleetFrontend, ReplicaHandle
from paddle_tpu_torch.tools import serve_fleet

# the reference drill's deployment (bench.py --frontdoor-smoke)
DOC = {'model': 'tiny',
       'model_kwargs': {'num_layers': 2, 'num_heads': 2, 'hidden_size': 32,
                        'vocab_size': 128, 'max_seq_len': 128},
       'block_size': 8, 'max_slots': 4, 'decode_span': 4,
       'num_blocks': 64, 'temperature': 0.7, 'top_k': 8, 'seed': 13}


def _shape(i):
    """A seeded request shape: (prompt, new tokens)."""
    import random
    rng = random.Random(1000 + i)
    return ([rng.randrange(1, 120) for _ in range(rng.randrange(4, 9))],
            rng.randrange(6, 10))


@pytest.fixture(scope='module')
def reference_engine():
    return serve_fleet.build_engine(DOC, device='cpu')


def _single(eng, rid, prompt, n):
    req = Request(rid, prompt, max_new_tokens=n)
    eng.submit(req)
    eng.run()
    return [int(t) for t in req.tokens]


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('fleet')
    config = workdir / 'serve.json'
    config.write_text(json.dumps(DOC))
    router = serve_fleet.launch_fleet(
        str(config), replicas=2, spares=1, workdir=str(workdir),
        device='cpu', metrics=True,
        extra_env={'PADDLE_TPU_MEMSTATS': 'interval=0.2'})
    door = FleetFrontend(router).start()
    yield router, door
    door.stop()
    router.stop()
    for rep in router.replicas + router.spares:
        assert not rep.alive() or rep.proc.poll() is not None


def _many(router, rids, shapes, pace_s=0.0, on_token=None):
    results, threads = {}, []

    def one(rid, prompt, n):
        try:
            results[rid] = router.generate(
                prompt, n, rid, on_token=None if on_token is None else
                (lambda i, t: on_token(rid, i, t)))
        except Exception as e:          # a crash is the finding
            results[rid] = {'state': 'crashed', 'reason': repr(e)}
    for rid, (prompt, n) in zip(rids, shapes):
        t = threading.Thread(target=one, args=(rid, prompt, n),
                             daemon=True)
        t.start()
        threads.append(t)
        time.sleep(pace_s)
    for t in threads:
        t.join(120)
    return results


def _sheds(router):
    n = 0
    for rep in router.replicas + router.spares:
        if rep.alive():
            n += sum(rep.status()['shed_counts'].values())
    return n


# ------------------------------------------------------- real fleet --
def test_workers_are_port_processes_on_the_asked_device(fleet):
    router, door = fleet
    assert len(router.replicas) == 2 and len(router.spares) == 1
    for rep in router.replicas + router.spares:
        assert rep.alive() and rep.proc is not None
        cmd = rep.proc.args
        assert cmd[1:4] == ['-m', 'paddle_tpu_torch.tools.serve_fleet',
                            'worker']
        assert cmd[cmd.index('--device') + 1] == 'cpu'
        # the worker's metrics plane: kernel launches (the CPU runs the
        # plain twins, so none) and the memory sampler's census
        plane = ReplicaHandle('plane', port=rep.metrics_port)
        doc = plane.get_json('/kernels/status.json')
        assert doc['launches']['fused_layer_norm'] == 0
        assert 'fused_layer_norm:warp' in doc['launches']
        assert doc['graphs'] == {}
        deadline = time.monotonic() + 30
        while 'device_bytes' not in plane.get_json('/memory.json')['live'] \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert plane.get_json('/memory.json')['live']['device_bytes'] > 0
    door_handle = ReplicaHandle.attach('door', door.url)
    assert door_handle.get_json('/healthz')['ok']


def test_clean_twin_is_bit_exact_and_sheds_nothing(fleet, reference_engine):
    router, _door = fleet
    shed0 = _sheds(router)
    rids = [f'cl-{i}' for i in range(4)]
    shapes = [_shape(i) for i in range(4)]
    res = _many(router, rids, shapes, pace_s=0.2)
    assert _sheds(router) == shed0
    for rid, (prompt, n) in zip(rids, shapes):
        assert res[rid]['state'] == 'finished', res[rid]
        assert res[rid]['tokens'] == _single(reference_engine, rid,
                                             prompt, n), rid
    assert router.check_invariants() == []


def test_overload_sheds_typed_and_every_rid_is_terminal(fleet):
    router, _door = fleet
    rids = [f'ov-{i}' for i in range(32)]
    shapes = [(_shape(i)[0], 24) for i in range(32)]
    res = _many(router, rids, shapes)
    states = {}
    for r in res.values():
        states[r['state']] = states.get(r['state'], 0) + 1
    assert set(states) <= {'finished', 'rejected'}, states
    assert states.get('finished')
    for r in res.values():
        if r['state'] == 'rejected':
            assert r['reason'] in RejectReason.ALL
    assert _sheds(router) > 0
    assert all(rep.alive() for rep in router.replicas)
    assert router.check_invariants() == []


def test_seeded_replica_kill_retries_bit_exact_and_promotes(
        fleet, reference_engine):
    router, _door = fleet
    plan = FaultPlan(seed=0, faults=[
        Fault('replica_kill', after_tokens=3, count=1)])
    inj = ServingFaultInjector(plan)
    lock = threading.Lock()

    def tap(rid, i, tok):
        with lock:
            fired = inj.fleet_faults(rid, i + 1)
        for _f in fired:
            victim = router.replica(router.ledger[rid]['replicas'][-1])
            victim.kill(signal.SIGKILL)

    rids = [f'ki-{i}' for i in range(3)]
    shapes = [_shape(100 + i) for i in range(3)]
    res = _many(router, rids, shapes, pace_s=0.05, on_token=tap)
    assert len(inj.injected) == 1
    killed = inj.injected[0]['rid']
    assert res[killed]['retried'] >= 1
    for rid, (prompt, n) in zip(rids, shapes):
        assert res[rid]['state'] == 'finished', res[rid]
        assert res[rid]['tokens'] == _single(reference_engine, rid,
                                             prompt, n), rid
    actions = [e['action'] for e in router.events]
    assert 'replica_down' in actions and 'promote' in actions
    assert not router.spares
    assert router.check_invariants() == []


def test_forced_slo_breach_drains_with_zero_dropped_tokens(
        fleet, reference_engine):
    router, _door = fleet
    prompt, n = _shape(200)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        e=router.generate(prompt, n, 'dr-0')), daemon=True)
    t.start()
    while 'dr-0' not in router.ledger or \
            not router.ledger['dr-0']['replicas']:
        time.sleep(0.01)
    owner = router.replica(router.ledger['dr-0']['replicas'][-1])
    st, body = owner.post_json('/admin/alert/slo_breach')
    assert st == 200 and 'slo_breach' in body['alerts']
    router.health_tick()
    t.join(120)
    assert owner.draining
    assert out['e']['state'] == 'finished'
    assert out['e']['tokens'] == _single(reference_engine, 'dr-0',
                                         prompt, n)
    assert any(e['action'] == 'drain' for e in router.events)
    assert router.dispatchable()
    after = router.generate(*_shape(201), 'dr-1')
    assert after['state'] == 'finished'
    assert router.check_invariants() == []


# ------------------------------------------------ scripted replicas --
class _ScriptedReplica(ThreadingHTTPServer):
    """A fake replica: /status.json from a dict; streams a scripted
    token list, then drops the connection without a terminal event if
    told to (a dying replica), or 429s every generate (a full one)."""

    def __init__(self, status=None, tokens=(), die_after=None,
                 reject=False):
        super().__init__(('127.0.0.1', 0), _ScriptedHandler)
        self.daemon_threads = True
        self.status_doc = dict(status or {})
        self.status_doc.setdefault('ok', True)
        self.tokens = list(tokens)
        self.die_after = die_after
        self.reject = reject
        threading.Thread(target=self.serve_forever, daemon=True).start()

    def handle(self, mod=port_router):
        """An attached handle of ``mod``'s router."""
        port = self.server_address[1]
        return mod.ReplicaHandle.attach(f'fake:{port}',
                                        f'http://127.0.0.1:{port}')


class _ScriptedHandler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'

    def log_message(self, *args):
        pass

    def _chunk(self, data):
        self.wfile.write(b'%X\r\n%s\r\n' % (len(data), data))

    def do_GET(self):                   # noqa: N802
        doc = (self.server.status_doc if self.path == '/status.json'
               else {'ok': True})
        data = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):                  # noqa: N802
        srv = self.server
        self.rfile.read(int(self.headers.get('Content-Length') or 0))
        if srv.reject:
            data = json.dumps({'error': RejectReason.QUEUE_FULL,
                               'detail': 'scripted',
                               'retry_after_s': 0.05}).encode()
            self.send_response(429)
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self.send_response(200)
        self.send_header('Transfer-Encoding', 'chunked')
        self.end_headers()
        emit = srv.tokens if srv.die_after is None \
            else srv.tokens[:srv.die_after]
        for i, tok in enumerate(emit):
            self._chunk(b'data: ' + json.dumps(
                {'i': i, 'token': int(tok)}).encode() + b'\n\n')
            self.wfile.flush()
        if srv.die_after is not None:
            # mid-stream death: the peer sees EOF now (a close() alone
            # leaves the socket open through rfile/wfile)
            self.close_connection = True
            self.connection.shutdown(socket.SHUT_RDWR)
            return
        self._chunk(b'data: ' + json.dumps(
            {'done': True, 'state': 'done',
             'reason': 'max_tokens'}).encode() + b'\n\n')
        self.wfile.write(b'0\r\n\r\n')


IDLE = {'kv_occupancy': 0.0, 'queue_depth': 0, 'max_queue': 8, 'live': 0,
        'max_slots': 4, 'in_flight': 0}


# both routers over the same replicas; the port's must do what the
# reference's does: the same picks, ledger entries, events and
# invariants
ROUTERS = (port_router, ref_router)
TELEMETRY = {port_router: tel, ref_router: ref_tel}


def _outcome(entry):
    """What a ledger entry says of its request (no timing in it)."""
    return {k: entry.get(k) for k in ('rid', 'state', 'reason', 'tokens',
                                      'attempts', 'replicas', 'retried',
                                      'retry_after_s')}


def _fleet_events(mod):
    return [{k: v for k, v in e.items() if k not in ('kind', 'ts', 't')}
            for e in TELEMETRY[mod].events('fleet_event')]


@pytest.fixture(scope='module')
def real_replica(reference_engine):
    """A port engine behind the port's door."""
    eng = serve_fleet.build_engine(DOC, device='cpu')
    fe = ServingFrontend(eng, port=0).start()
    yield fe
    fe.stop()


def test_worker_kernel_source_reads_launches_and_replays(real_replica):
    """``/kernels/status.json``: launches by kernel and design beside
    each captured graph's replays, read under the lock a replay is
    counted under (it is free between reads)."""
    from paddle_tpu_torch.ops import _build
    fe = real_replica
    src = serve_fleet.KernelLaunches(fe.engine)
    before = src.snapshot()
    st, body = ReplicaHandle.attach('real', fe.url).post_json(
        '/v1/generate', {'prompt': [3, 1, 4], 'max_new_tokens': 5,
                         'rid': 'kl-0', 'stream': False})
    assert st == 200 and body['state'] == Request.DONE
    after = src.snapshot()
    assert not _build.counts_lock.locked()
    # the CPU captures no graph and launches no kernel (the plain twins)
    assert after == before and after['graphs'] == {}
    assert set(after['launches']) >= {'fused_layer_norm',
                                      'fused_layer_norm:warp'}
    assert 'paddle_tpu_kernel_launches_total{kernel="fused_layer_norm"} 0' \
        in src.prometheus()


def test_dispatch_prefers_low_load(real_replica):
    url = real_replica.url
    busy = _ScriptedReplica(status={'kv_occupancy': 0.9, 'queue_depth': 7,
                                    'max_queue': 8, 'live': 4,
                                    'max_slots': 4})
    idle, twin = (_ScriptedReplica(status=IDLE) for _ in range(2))
    try:
        picks = {}
        for mod in ROUTERS:
            real = mod.ReplicaHandle.attach('real', url)
            a, b, c = (r.handle(mod) for r in (busy, idle, twin))
            picks[mod] = [mod.FleetRouter(reps).pick().name for reps in (
                [a, real], [real, a], [b, real], [real, b], [a, b],
                [b, c], [c, b])]
        assert picks[port_router] == picks[ref_router]
        assert picks[port_router][:2] == ['real', 'real']
        assert picks[port_router][4] == idle.handle().name
        # equal loads: the first listed wins
        assert picks[port_router][5:] == [idle.handle().name,
                                          twin.handle().name]
    finally:
        for r in (busy, idle, twin):
            r.shutdown()


def test_midstream_death_retries_bit_exact(real_replica, reference_engine):
    url = real_replica.url
    prompt, n = [1, 2, 3, 4, 5], 8
    ref = _single(reference_engine, 'rt-0', prompt, n)
    dying = _ScriptedReplica(status=IDLE, tokens=ref, die_after=3)
    got = {}
    try:
        for mod in ROUTERS:
            TELEMETRY[mod].reset()
            router = mod.FleetRouter([dying.handle(mod),
                                      mod.ReplicaHandle.attach('real', url)])
            delivered = []
            entry = router.generate(prompt, n, 'rt-0',
                                    on_token=lambda i, t: delivered.append(
                                        (i, t)))
            got[mod] = (_outcome(entry), delivered, router.events,
                        _fleet_events(mod), router.check_invariants())
        assert got[port_router] == got[ref_router]
        entry, delivered, events, recorded, problems = got[port_router]
        assert entry['state'] == 'finished' and entry['retried'] == 1
        assert entry['tokens'] == ref
        assert delivered == list(enumerate(ref))     # at most once
        retry = [e for e in events if e['action'] == 'retry']
        assert retry and retry[0]['offset'] == 3
        assert recorded == events
        assert problems == []
    finally:
        dying.shutdown()


def test_rejection_exhausts_typed_never_silent():
    full = [_ScriptedReplica(status=IDLE, reject=True) for _ in range(2)]
    got = {}
    try:
        for mod in ROUTERS:
            router = mod.FleetRouter([r.handle(mod) for r in full],
                                     max_attempts=2)
            entry = router.generate([1, 2, 3], 4, 'rj-0')
            # a router with no replica at all fails typed too
            empty = mod.FleetRouter([])
            got[mod] = (_outcome(entry), router.events,
                        router.check_invariants(),
                        _outcome(empty.generate([1], 2, 'rj-1')),
                        empty.check_invariants())
        assert got[port_router] == got[ref_router]
        entry, _events, problems, none, none_problems = got[port_router]
        assert entry['state'] == 'rejected'
        assert entry['reason'] == RejectReason.QUEUE_FULL
        assert entry['attempts'] == 2
        assert problems == []
        assert none['state'] == 'failed' and none_problems == []
    finally:
        for r in full:
            r.shutdown()


def test_forced_alert_drains_and_promotes_the_spare(real_replica):
    url = real_replica.url
    spare = _ScriptedReplica(status=IDLE)
    got = {}
    try:
        st, body = ReplicaHandle.attach('real', url).post_json(
            '/admin/alert/memory_pressure')
        assert st == 200 and 'memory_pressure' in body['alerts']
        for mod in ROUTERS:
            handle = mod.ReplicaHandle.attach('real', url)
            router = mod.FleetRouter([handle], spares=[spare.handle(mod)])
            router.health_tick()
            got[mod] = (handle.draining, handle.down, router.events,
                        [r.name for r in router.dispatchable()],
                        [r.name for r in router.spares])
        assert got[port_router] == got[ref_router]
        draining, _down, events, dispatchable, spares = got[port_router]
        assert draining
        actions = [e['action'] for e in events]
        assert 'drain' in actions and 'promote' in actions
        assert dispatchable == [spare.handle().name] and spares == []
    finally:
        spare.shutdown()


def test_fleet_door_and_duplicate_rid(reference_engine):
    eng = serve_fleet.build_engine(DOC, device='cpu')
    fe = ServingFrontend(eng, port=0).start()
    got = {}
    try:
        for mod in ROUTERS:
            router = mod.FleetRouter([mod.ReplicaHandle.attach('r', fe.url)])
            door = mod.FleetFrontend(router, port=0).start()
            try:
                door_handle = ReplicaHandle.attach('door', door.url)
                replies = [door_handle.post_json('/v1/generate', {
                    'prompt': [2, 4, 6], 'max_new_tokens': 4, 'rid': 'fd-1',
                    'stream': False}) for _ in range(2)]
                replies.append(door_handle.post_json('/v1/cancel/nope'))
                got[mod] = (replies, router.events,
                            router.check_invariants())
            finally:
                door.stop()
        assert got[port_router] == got[ref_router]
        (first, dup, cancel), _events, problems = got[port_router]
        assert first[0] == 200 and first[1]['state'] == 'finished'
        assert first[1]['tokens'] == _single(reference_engine, 'fd-1',
                                             [2, 4, 6], 4)
        assert dup[0] == 400 and 'duplicate' in dup[1]['detail']
        assert cancel[0] == 404
        assert problems == []
    finally:
        fe.stop()


# ------------------------------------------------------------ chaos --
def _plan(mod):
    return mod.FaultPlan(seed=4, name='drill', faults=[
        mod.Fault('replica_kill', after_tokens=3, count=1, rank=0),
        mod.Fault('client_disconnect', after_tokens=2, count=1,
                  path='cd-'),
        mod.Fault('slow_client', after_tokens=0, count=2, delay_s=0.5),
        mod.Fault('replica_hang', after_tokens=5, count=1),
        mod.Fault('sigkill', at_step=3),
    ])


def test_injector_matches_the_reference():
    for t in (tel, ref_tel):
        t.reset()
    assert FAULT_KINDS == ref_chaos.FAULT_KINDS
    assert SERVING_FAULT_KINDS == ref_chaos.SERVING_FAULT_KINDS
    got = ServingFaultInjector(_plan(chaos), telemetry=tel)
    want = ref_chaos.ServingFaultInjector(_plan(ref_chaos),
                                          telemetry=ref_tel)
    calls = [('fleet', 'r-1', 2, 0), ('fleet', 'r-1', 3, 1),
             ('fleet', 'r-1', 3, 0), ('fleet', 'r-1', 4, 0),
             ('client', 'other', 1), ('client', 'cd-7', 2),
             ('client', 'cd-7', 3), ('fleet', 'x', 6, None),
             ('client', 'y', 0), ('fleet', 'x', 9, 1)]
    for call in calls:
        for inj in (got, want):
            if call[0] == 'fleet':
                inj.fleet_faults(*call[1:])
            else:
                inj.client_faults(*call[1:])
        assert got.injected == want.injected, call
    assert {f['fault'] for f in got.injected} == set(SERVING_FAULT_KINDS)
    strip = [{k: v for k, v in e.items() if k not in ('ts', 't')}
             for e in tel.events('fault_injected')]
    assert strip == [{k: v for k, v in e.items() if k not in ('ts', 't')}
                     for e in ref_tel.events('fault_injected')]


def test_plans_serialise_and_refuse_as_the_reference(monkeypatch):
    assert _plan(chaos).to_json() == _plan(ref_chaos).to_json()
    text = _plan(ref_chaos).to_json()
    assert chaos.FaultPlan.from_json(text).to_json() == text
    monkeypatch.setenv('PADDLE_TPU_CHAOS_PLAN', text)
    assert plan_from_env().to_json() == text
    for bad in ('replica_explode', 'bogus'):
        with pytest.raises(ValueError) as got:
            Fault(bad)
        with pytest.raises(ValueError) as want:
            ref_chaos.Fault(bad)
        assert str(got.value) == str(want.value)
    for mod in (chaos, ref_chaos):
        plan = mod.FaultPlan(seed=1, faults=[
            mod.Fault('replica_kill', after_tokens=1, count=1, rank=1),
            mod.Fault('slow_client', count=1)])
        sliced = plan.slice_for_rank(0)
        assert [f.kind for f in sliced.faults] == ['slow_client']
    assert 'after_tokens' not in Fault('sigkill', at_step=3).to_dict()
