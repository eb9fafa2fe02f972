"""Multi-engine serving router: N ServingEngine replicas behind ONE
door, with proven failure semantics (the port's copy of
``paddle_tpu/serving/router.py``).

Three pieces:

* :class:`ReplicaHandle` — one engine replica: either a spawned
  ``python -m paddle_tpu_torch.tools.serve_fleet worker`` subprocess
  (its own process, hence its own CUDA context, env-configured, port
  published through a file) or an attached already-running frontend
  URL (in-process tests).  Thin HTTP client helpers over the
  replica's front door.  A spawned worker runs on the device the fleet
  was given (``--device``, ``cuda`` by default): the environment,
  ``CUDA_VISIBLE_DEVICES`` included, is passed on unchanged, so every
  worker takes the card unless the fleet asked for ``device='cpu'``.

* :class:`FleetRouter` — the dispatch + supervision brain:

  - **dispatch** is KV-occupancy- and queue-depth-aware, fed by each
    replica's live ``/status.json`` (lowest composite load wins;
    draining/down replicas excluded);
  - **retry**: a replica that dies (or hangs past the read timeout)
    mid-stream gets its in-flight requests replayed on a surviving
    replica as ``prompt + emitted-prefix`` with the SAME rid — the
    per-request position-keyed sampling discipline (ops/sampling)
    makes the continuation bit-exact, and every token carries its
    global stream offset so delivery is at-most-once;
  - **drain + warm-spare promotion**: a replica whose status latches
    ``slo_breach``/``memory_pressure`` is drained (stops being
    dispatched to, finishes in-flight, typed-rejects new) while a
    pre-warmed spare is promoted into the active set — zero dropped
    in-flight requests;
  - **ledger**: every rid the router ever accepted reaches EXACTLY
    one terminal state — ``finished`` | ``evicted(cause)`` |
    ``rejected(type)`` | ``failed(cause)`` — and
    :meth:`FleetRouter.check_invariants` proves it the way the chaos
    harness's I1–I7 are proven, never claims it.

* :class:`FleetFrontend` — the one public door: re-serves
  ``POST /v1/generate`` (SSE re-streaming through the router's retry
  machinery), ``/v1/cancel/<rid>``, ``/healthz``, ``/status.json``
  in the same stdlib posture as the single-engine frontend.

Control-plane actions emit ``fleet_event`` telemetry
(dispatch retries, drains, promotions, replica deaths) — run_report
renders them on the timeline next to the ``serve_reject`` shed trail.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler

from .. import telemetry
from .frontend import DoorServer
from .scheduler import RejectReason, RejectedRequest

__all__ = ['ReplicaHandle', 'ReplicaDied', 'FleetRouter',
           'FleetFrontend']

# the directory that holds the paddle_tpu_torch package
_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


class ReplicaDied(ConnectionError):
    """The replica serving a stream went away (process death, socket
    reset, or a read stalled past the hang timeout)."""


class ReplicaHandle:
    """One serving replica — spawned subprocess or attached URL."""

    def __init__(self, name, host='127.0.0.1', port=None, proc=None,
                 port_file=None):
        self.name = name
        self.host = host
        self.port = port
        self.proc = proc
        self.port_file = port_file
        self.draining = False
        self.down = False
        self.last_status = None
        self.metrics_port = None    # a spawned worker's, if armed

    # -- construction --------------------------------------------------------
    @classmethod
    def attach(cls, name, url):
        """Wrap an already-listening frontend (in-process tests)."""
        host, port = url.split('//', 1)[-1].rsplit(':', 1)
        return cls(name, host=host, port=int(port))

    @classmethod
    def spawn(cls, name, config_path, workdir, host='127.0.0.1',
              warmup=False, extra_env=None, device='cuda', metrics=False):
        """Start one ``paddle_tpu_torch.tools.serve_fleet worker``
        subprocess (``Popen`` of a fresh interpreter, never a fork: the
        caller may hold a CUDA context) on ``device``, the package on
        PYTHONPATH, its port published through a file once the door is
        open.  ``metrics=True`` arms the worker's live metrics plane on
        an ephemeral port (``metrics_port`` once ready)."""
        os.makedirs(workdir, exist_ok=True)
        port_file = os.path.join(workdir, f'{name}.port')
        log = open(os.path.join(workdir, f'{name}.log'), 'ab')
        cmd = [sys.executable, '-m', 'paddle_tpu_torch.tools.serve_fleet',
               'worker', '--config', config_path,
               '--port-file', port_file, '--host', host,
               '--device', str(device)]
        if warmup:
            cmd.append('--warmup')
        if metrics:
            cmd += ['--metrics-port', '0']
        env = dict(os.environ)
        env['PYTHONPATH'] = _REPO + os.pathsep + env.get('PYTHONPATH', '')
        env.update(extra_env or {})
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log,
                                start_new_session=True)
        log.close()
        return cls(name, host=host, proc=proc, port_file=port_file)

    def wait_ready(self, timeout_s=120.0):
        """Block until the worker published its port and /healthz
        answers; raises on worker death or timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f'replica {self.name} exited rc='
                    f'{self.proc.returncode} before becoming ready')
            if self.port is None and self.port_file \
                    and os.path.exists(self.port_file):
                try:
                    with open(self.port_file) as f:
                        doc = json.load(f)
                    self.port = int(doc['port'])
                    self.metrics_port = doc.get('metrics_port')
                except (ValueError, KeyError, OSError):
                    pass                # partial write; retry
            if self.port is not None:
                try:
                    if self.get_json('/healthz').get('ok'):
                        return self
                except OSError:
                    pass
            time.sleep(0.05)
        raise TimeoutError(f'replica {self.name} not ready after '
                           f'{timeout_s}s')

    # -- liveness ------------------------------------------------------------
    def alive(self):
        if self.down:
            return False
        if self.proc is not None and self.proc.poll() is not None:
            return False
        return True

    def kill(self, sig=signal.SIGKILL):
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.send_signal(sig)
            except ProcessLookupError:
                pass

    def reap(self, timeout_s=10.0):
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.kill()
                self.proc.wait(timeout=timeout_s)

    # -- HTTP client ---------------------------------------------------------
    def _conn(self, timeout_s):
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)

    def get_json(self, path, timeout_s=10.0):
        c = self._conn(timeout_s)
        try:
            c.request('GET', path)
            r = c.getresponse()
            return json.loads(r.read().decode('utf-8'))
        finally:
            c.close()

    def post_json(self, path, doc=None, timeout_s=10.0):
        c = self._conn(timeout_s)
        try:
            c.request('POST', path,
                      body=json.dumps(doc) if doc is not None else '',
                      headers={'Content-Type': 'application/json'})
            r = c.getresponse()
            return r.status, json.loads(r.read().decode('utf-8'))
        finally:
            c.close()

    def status(self, timeout_s=5.0):
        doc = self.get_json('/status.json', timeout_s=timeout_s)
        self.last_status = doc
        return doc

    def drain(self):
        self.draining = True
        try:
            self.post_json('/admin/drain')
        except OSError:
            pass
        return self

    def stream_generate(self, doc, read_timeout_s=30.0):
        """POST /v1/generate and yield parsed SSE events.  Raises
        :class:`ReplicaDied` on any transport failure — including a
        read that stalls past ``read_timeout_s`` (a SIGSTOPped
        replica looks exactly like that)."""
        c = self._conn(read_timeout_s)
        try:
            try:
                c.request('POST', '/v1/generate', body=json.dumps(doc),
                          headers={'Content-Type': 'application/json'})
                r = c.getresponse()
            except OSError as e:
                raise ReplicaDied(f'{self.name}: {e!r}')
            if r.status != 200:
                try:
                    body = json.loads(r.read().decode('utf-8'))
                except (OSError, ValueError) as e:
                    raise ReplicaDied(f'{self.name}: unreadable '
                                      f'rejection body: {e!r}')
                exc = RejectedRequest(
                    body.get('error', RejectReason.QUEUE_FULL),
                    body.get('detail', ''), rid=body.get('rid'))
                exc.retry_after_s = body.get('retry_after_s')
                raise exc
            while True:
                try:
                    line = r.readline()
                except OSError as e:    # timeout / reset mid-stream
                    raise ReplicaDied(f'{self.name}: {e!r}')
                if not line:
                    raise ReplicaDied(
                        f'{self.name}: stream ended without a '
                        'terminal event')
                line = line.strip()
                if not line.startswith(b'data: '):
                    continue
                try:
                    ev = json.loads(line[len(b'data: '):])
                except ValueError:
                    # a replica SIGKILLed mid-write leaves a truncated
                    # line in the socket buffer — that is a death, not
                    # a protocol error to leak to the caller
                    raise ReplicaDied(
                        f'{self.name}: truncated event mid-stream')
                yield ev
                if ev.get('done'):
                    return
        finally:
            c.close()


class FleetRouter:
    """Dispatch + retry + drain/promote over a set of replicas."""

    def __init__(self, replicas, spares=(), max_attempts=3,
                 read_timeout_s=30.0, poll_s=0.25):
        self.replicas = list(replicas)      # active set
        self.spares = list(spares)          # warm, not dispatched to
        self.max_attempts = int(max_attempts)
        self.read_timeout_s = float(read_timeout_s)
        self.poll_s = float(poll_s)
        self.ledger = {}                    # rid -> entry dict
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._health_thread = None
        self.events = []                    # local fleet_event record

    # -- telemetry -----------------------------------------------------------
    def _fleet_event(self, action, **data):
        ev = dict(action=action, **{k: v for k, v in data.items()
                                    if v is not None})
        self.events.append(ev)
        telemetry.event('fleet_event', **ev)

    # -- replica set ---------------------------------------------------------
    def replica(self, name):
        for r in self.replicas + self.spares:
            if r.name == name:
                return r
        return None

    def mark_down(self, rep, cause='dead'):
        if rep.down:
            return
        rep.down = True
        self._fleet_event('replica_down', replica=rep.name,
                          cause=cause)
        self.promote_spare()

    def promote_spare(self):
        """Move one warm spare into the active set (pre-warmed via
        warmup(), which captured every graph, so promotion captures
        nothing)."""
        with self._lock:
            while self.spares:
                rep = self.spares.pop(0)
                if not rep.alive():
                    continue
                self.replicas.append(rep)
                self._fleet_event('promote', replica=rep.name)
                return rep
        return None

    def drain_replica(self, rep, cause='manual'):
        """Stop dispatching to `rep`, let in-flight finish, promote a
        spare to cover.  The health loop retires it (kills the
        process) once its in-flight count reaches zero."""
        if rep.draining:
            return rep
        rep.drain()
        self._fleet_event('drain', replica=rep.name, cause=cause)
        self.promote_spare()
        return rep

    def dispatchable(self):
        return [r for r in self.replicas
                if r.alive() and not r.draining]

    def pick(self, exclude=()):
        """Load-aware dispatch: live occupancy + queue depth from
        each candidate's /status.json (a replica that cannot answer
        its own status is not a replica you want to dispatch to)."""
        best, best_score = None, None
        for rep in self.dispatchable():
            if rep.name in exclude:
                continue
            try:
                st = rep.status(timeout_s=2.0)
            except OSError:
                continue
            if st.get('draining'):
                rep.draining = True
                continue
            score = (st.get('kv_occupancy') or 0.0) \
                + st.get('queue_depth', 0) / max(1, st.get('max_queue')
                                                 or 1) \
                + st.get('live', 0) / max(1, st.get('max_slots') or 1)
            if best_score is None or score < best_score:
                best, best_score = rep, score
        return best

    # -- the request path ----------------------------------------------------
    def generate(self, prompt, max_new_tokens, rid, on_token=None,
                 deadline_s=None):
        """Run one request to a TERMINAL state, surviving replica
        death mid-stream.  ``on_token(i, token)`` fires exactly once
        per global stream offset (at-most-once delivery: a retry
        resumes from the last delivered offset via
        prompt+emitted-prefix replay).  Returns the ledger entry."""
        prompt = [int(t) for t in prompt]
        max_new_tokens = int(max_new_tokens)
        with self._lock:
            if rid in self.ledger:
                raise ValueError(f'duplicate rid {rid!r}')
            entry = {'rid': rid, 'state': 'in_flight', 'reason': None,
                     'tokens': [], 'attempts': 0, 'replicas': [],
                     'retried': 0}
            self.ledger[rid] = entry
        tokens = entry['tokens']
        tried_dead = set()
        while True:
            rep = self.pick(exclude=tried_dead)
            if rep is None and tried_dead:
                # every untried replica is gone; one more chance on
                # ANY dispatchable (a promoted spare may have landed)
                rep = self.pick()
            if rep is None:
                return self._terminal(entry, 'failed', 'no_replica')
            entry['attempts'] += 1
            entry['replicas'].append(rep.name)
            prefix = len(tokens)
            if entry['attempts'] > 1:
                entry['retried'] += 1
                self._fleet_event('retry', rid=rid, replica=rep.name,
                                  offset=prefix)
            doc = {'prompt': prompt + tokens,
                   'max_new_tokens': max_new_tokens - prefix,
                   'rid': rid, 'stream': True}
            if deadline_s is not None:
                doc['deadline_s'] = deadline_s
            try:
                for ev in rep.stream_generate(
                        doc, read_timeout_s=self.read_timeout_s):
                    if 'token' in ev:
                        i = prefix + int(ev['i'])
                        if i == len(tokens):    # at-most-once
                            tokens.append(int(ev['token']))
                            if on_token is not None:
                                try:
                                    on_token(i, tokens[i])
                                except BaseException:
                                    # the CLIENT went away — the
                                    # replica is fine: evict there,
                                    # terminalize here (a rid must
                                    # never stick at in_flight), then
                                    # let the caller see the error
                                    try:
                                        rep.post_json(
                                            f'/v1/cancel/{rid}')
                                    except OSError:
                                        pass
                                    self._terminal(entry, 'evicted',
                                                   'client_lost')
                                    raise
                    elif ev.get('done'):
                        state = ('finished' if ev.get('state') == 'done'
                                 else 'evicted')
                        return self._terminal(entry, state,
                                              ev.get('reason'))
            except RejectedRequest as e:
                entry['retry_after_s'] = getattr(
                    e, 'retry_after_s', None)
                if entry['attempts'] < self.max_attempts:
                    tried_dead.add(rep.name)
                    continue            # another replica may admit it
                return self._terminal(entry, 'rejected', e.reason)
            except ReplicaDied as e:
                tried_dead.add(rep.name)
                if not rep.alive() or rep.proc is not None:
                    # a stream that died on a live process means the
                    # process is wedged (hang) — kill it so its KV
                    # blocks and port free up before the retry lands
                    if rep.alive():
                        rep.kill()
                    self.mark_down(rep, cause='stream_lost')
                if entry['attempts'] >= self.max_attempts:
                    return self._terminal(entry, 'failed',
                                          f'replica_lost:{e}')
                if len(tokens) >= max_new_tokens:
                    # the dead replica had already emitted everything
                    return self._terminal(entry, 'finished',
                                          'max_tokens')

    def _terminal(self, entry, state, reason):
        with self._lock:
            assert entry['state'] == 'in_flight', \
                f"rid {entry['rid']} reached two terminal states"
            entry['state'] = state
            entry['reason'] = reason
        return entry

    def cancel(self, rid):
        """Forward a cancel to the replica currently streaming it."""
        entry = self.ledger.get(rid)
        if entry is None or entry['state'] != 'in_flight':
            return False
        for name in reversed(entry['replicas']):
            rep = self.replica(name)
            if rep is not None and rep.alive():
                try:
                    st, _doc = rep.post_json(f'/v1/cancel/{rid}')
                    return st == 200
                except OSError:
                    continue
        return False

    # -- supervision ---------------------------------------------------------
    def start_health_loop(self):
        self._health_thread = threading.Thread(
            target=self._health_loop, name='paddle-tpu-fleet-health',
            daemon=True)
        self._health_thread.start()
        return self

    def _health_loop(self):
        while not self._stop.wait(self.poll_s):
            self.health_tick()

    def health_tick(self):
        """ONE supervision pass: detect deaths, drain on latched
        alerts, retire drained replicas whose in-flight hit zero."""
        for rep in list(self.replicas):
            if rep.down:
                continue
            if not rep.alive():
                self.mark_down(rep, cause='process_exit')
                continue
            try:
                st = rep.status(timeout_s=2.0)
            except OSError:
                # unreachable but process alive: transient (status is
                # best-effort; the stream path has its own detection)
                continue
            alerts = [a for a in st.get('alerts', ())
                      if a in ('slo_breach', 'memory_pressure')]
            if alerts and not rep.draining:
                self.drain_replica(rep, cause=alerts[0])
            if rep.draining and st.get('in_flight', 1) == 0:
                self._fleet_event('retire', replica=rep.name)
                rep.down = True
                rep.kill(signal.SIGTERM)

    def stop(self, kill=True):
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        if kill:
            for rep in self.replicas + self.spares:
                rep.kill(signal.SIGTERM)
            for rep in self.replicas + self.spares:
                rep.reap()

    # -- status + invariants -------------------------------------------------
    def status(self):
        per = {}
        for rep in self.replicas + self.spares:
            role = 'spare' if rep in self.spares else 'active'
            doc = {'role': role, 'alive': rep.alive(),
                   'draining': rep.draining, 'down': rep.down}
            if rep.last_status:
                doc.update({k: rep.last_status.get(k) for k in
                            ('kv_occupancy', 'queue_depth', 'live',
                             'in_flight', 'shed_counts', 'alerts')})
            per[rep.name] = doc
        with self._lock:
            states = {}
            for e in self.ledger.values():
                states[e['state']] = states.get(e['state'], 0) + 1
        return {'ok': bool(self.dispatchable()),
                'replicas': per, 'ledger': states,
                'events': len(self.events)}

    def check_invariants(self):
        """Router invariants, checked like chaos I1–I7; returns the
        violation list (empty = green).

        R1  every accepted rid is terminal: finished | evicted(cause)
            | rejected(type) | failed(cause) — never in_flight once
            the fleet is quiet, never silently lost;
        R2  terminal exactly once (enforced at transition; re-checked
            here);
        R3  a finished entry holds exactly the tokens it delivered —
            contiguous offsets, no gaps or duplicates (at-most-once
            delivery made at-least-once by retry = exactly-once);
        R4  a rejected entry carries a typed RejectReason.
        """
        problems = []
        with self._lock:
            entries = list(self.ledger.values())
        for e in entries:
            if e['state'] == 'in_flight':
                problems.append(f"R1: rid {e['rid']} not terminal")
            elif e['state'] not in ('finished', 'evicted', 'rejected',
                                    'failed'):
                problems.append(
                    f"R2: rid {e['rid']} bad state {e['state']!r}")
            if e['state'] in ('evicted', 'failed') \
                    and not e.get('reason'):
                problems.append(
                    f"R1: rid {e['rid']} {e['state']} without cause")
            if e['state'] == 'rejected' \
                    and e.get('reason') not in RejectReason.ALL:
                problems.append(
                    f"R4: rid {e['rid']} untyped rejection "
                    f"{e.get('reason')!r}")
        return problems


class FleetFrontend:
    """The fleet's ONE public door — same posture/routes as the
    single-engine frontend, but every request runs through the
    router's dispatch/retry machinery."""

    def __init__(self, router, port=0, host='127.0.0.1'):
        self.router = router
        self.requested_port = int(port)
        self.host = host
        self._httpd = None
        self._thread = None
        self.port = None
        self.started_t = time.monotonic()

    def start(self):
        httpd = DoorServer((self.host, self.requested_port),
                           _FleetHandler)
        httpd.fleet = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, name='paddle-tpu-fleet-http',
            daemon=True)
        self._thread.start()
        return self

    @property
    def url(self):
        return (None if self.port is None
                else f'http://{self.host}:{self.port}')

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'

    def log_message(self, *args):
        pass

    def _send_json(self, code, doc, headers=()):
        data = json.dumps(doc).encode('utf-8')
        self.send_response(code)
        self.send_header('Content-Type',
                         'application/json; charset=utf-8')
        self.send_header('Content-Length', str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_GET(self):                   # noqa: N802 (http.server API)
        fleet = self.server.fleet
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        try:
            if path == '/healthz':
                self._send_json(200, {
                    'ok': bool(fleet.router.dispatchable()),
                    'uptime_s': round(
                        time.monotonic() - fleet.started_t, 3)})
            elif path == '/status.json':
                self._send_json(200, fleet.router.status())
            else:
                self._send_json(404, {'error': 'not found'})
        except Exception as e:
            try:
                self._send_json(500, {'error': repr(e)[:200]})
            except Exception:
                pass

    def do_POST(self):                  # noqa: N802 (http.server API)
        fleet = self.server.fleet
        path = self.path.split('?', 1)[0].rstrip('/') or '/'
        try:
            if path == '/v1/generate':
                self._generate(fleet)
            elif path.startswith('/v1/cancel/'):
                rid = path[len('/v1/cancel/'):]
                hit = fleet.router.cancel(rid)
                self._send_json(200 if hit else 404,
                                {'rid': rid, 'cancelled': bool(hit)})
            else:
                self._send_json(404, {'error': 'not found'})
        except Exception as e:
            try:
                self._send_json(500, {'error': repr(e)[:200]})
            except Exception:
                pass

    def _generate(self, fleet):
        n = int(self.headers.get('Content-Length') or 0)
        doc = json.loads(self.rfile.read(n).decode('utf-8')) if n \
            else {}
        prompt = doc.get('prompt')
        rid = doc.get('rid')
        if not prompt or not rid:
            self._send_json(400, {'error': 'bad_request',
                                  'detail': 'prompt and rid required'})
            return
        router = fleet.router
        if doc.get('stream', True):
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-store')
            self.send_header('Transfer-Encoding', 'chunked')
            self.send_header('X-Request-Id', str(rid))
            self.end_headers()

            def chunk(data):
                self.wfile.write(b'%X\r\n%s\r\n' % (len(data), data))
                self.wfile.flush()

            def on_token(i, tok):
                chunk(b'data: ' + json.dumps(
                    {'i': i, 'token': tok}).encode('utf-8') + b'\n\n')

            try:
                entry = router.generate(
                    prompt, doc.get('max_new_tokens', 16), rid,
                    on_token=on_token,
                    deadline_s=doc.get('deadline_s'))
                chunk(b'data: ' + json.dumps(
                    {'done': True, 'rid': rid,
                     'n': len(entry['tokens']),
                     'state': entry['state'],
                     'reason': entry['reason'],
                     'retried': entry['retried']}).encode('utf-8')
                    + b'\n\n')
                chunk(b'')
            except (BrokenPipeError, ConnectionResetError, OSError):
                router.cancel(rid)
            except Exception as e:
                # a router bug must not strand the client mid-stream
                # with a silent EOF: terminalize the ledger entry and
                # send the terminal event the protocol promises
                entry = router.ledger.get(rid)
                if entry is not None \
                        and entry['state'] == 'in_flight':
                    router._terminal(entry, 'failed', repr(e)[:120])
                try:
                    chunk(b'data: ' + json.dumps(
                        {'done': True, 'rid': rid,
                         'n': len(entry['tokens']) if entry else 0,
                         'state': entry['state'] if entry
                         else 'failed',
                         'reason': entry['reason'] if entry
                         else repr(e)[:120]}).encode('utf-8')
                        + b'\n\n')
                    chunk(b'')
                except OSError:
                    pass
        else:
            try:
                entry = router.generate(
                    prompt, doc.get('max_new_tokens', 16), rid,
                    deadline_s=doc.get('deadline_s'))
            except ValueError as e:
                self._send_json(400, {'error': 'bad_request',
                                      'detail': str(e)})
                return
            code = 200
            body = {'rid': rid, 'tokens': entry['tokens'],
                    'state': entry['state'],
                    'reason': entry['reason'],
                    'retried': entry['retried']}
            headers = ()
            if entry['state'] == 'rejected':
                # same typed contract as the single-engine door:
                # machine-readable 'error' + Retry-After
                code = RejectReason.HTTP_STATUS.get(
                    entry['reason'], 503)
                body['error'] = entry['reason']
                retry = entry.get('retry_after_s')
                if retry:
                    body['retry_after_s'] = retry
                    headers = (('Retry-After',
                                str(max(1, int(round(retry)))),),)
            elif entry['state'] == 'failed':
                code = 502
            self._send_json(code, body, headers=headers)
